"""Quantisation ops: the fake-quant ops with straight-through grads, the
int8 execution ops and the s8 convolution kernel.

Counterpart of ``paddle_tpu/ops/quant.py``: the same 14 op types, slots,
attrs and defaults, the same errors and scale conventions.

- The fake-quant ops (``fake_quantize_abs_max`` and its channel-wise,
  moving-average, range and quant-dequant variants,
  ``fake_dequantize_max_abs``, ``fake_channel_wise_dequantize_max_abs``,
  ``moving_average_abs_max_scale``).  The straight-through estimator is
  ``x + (q - x).detach()``, whose value is the JAX package's ``x +
  stop_gradient(q - x)`` bit for bit and whose autograd is the identity.
- ``quantize`` (``:104``), ``dequantize`` (``:119``), ``requantize``
  (``:126``) and ``dequantize_weight`` (``:187``).
- ``conv2d_int8`` (``:251``) and ``mul_int8`` (``:372``): the activation
  quantised per tensor to int8 (a calibrated ``InScale``, or max|x|),
  an s8 x s8 product with an int32 accumulator, then the epilogue in the
  JAX package's op order and rounding points.  ``mul_int8`` enters the
  same kernel as a 1x1 convolution over ``[M, 1, 1, K]``.

The s8 products are XLA dots in the JAX package (``:228-243``,
``:335-340``, ``:462``).  Here they are ``csrc/conv_int8.cu``
(``pt_conv_int8``), an implicit GEMM with the epilogue fused, on two
routes (``kernel_route``): one group takes a persistent ``wgmma`` s8
kernel (w and a 1x1 conv's x by TMA; a stem of at most 4 channels packed,
a filter row's taps in one 32-byte K row, ``_stem_x_operand`` and
``_stem_filter_operand``), grouped convolutions the first ``mma.sync``
kernel, which every convolution also takes on request
(``route="mma_sync"``); the source's header says how each is laid out
and what bounds it.  The wrapper ``conv_int8`` launches the kernel on a
CUDA tensor (a build or launch failure raises; ``conv_int8.launches``
counts launches, ``conv_int8.launches_by_route`` by route) and takes the
plain version ``conv_int8_plain`` on a CPU or ``meta`` tensor.  The plain
version is exact: an f64 im2col product of the int8 operands, rounded to
int32 (``|sum| <= 127^2 * K < 2^53``), then the epilogue in PyTorch.  The
kernel reads x with whole 16-byte chunks of channels, so the wrapper pads
each group's channels to a multiple of 16 (the stem to 4, its width to
even padding), and copies a misaligned x; each such copy is counted in
``conv_int8.copies``.  Filters
are laid out (OHWI, padded; or packed) once per parameter and kept
(``_kept_filter``).  The activation's quantisation, which XLA fuses into
the dot's operand (``:325``, ``:460``), is ``csrc/quantize_act.cu``
through ``quantize_act`` (plain version ``quantize_act_plain``, counted in
``quantize_act.launches``); the dynamic max|x| stays a PyTorch reduction.
Flag ``int8_conv_algo`` picks one of two lowerings with the same bits in
the JAX package; the port accepts it for parity and does not read it.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.types import to_torch_dtype
from paddle_tpu_torch.ops.basic import _bcast_y
from paddle_tpu_torch.ops.epilogue import quantize_tail
from paddle_tpu_torch.ops.nn import _pair

_KERNEL = "conv_int8"
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.int32: 3}
_OPERAND_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 16  # channels of one 16-byte copy


def _promote(a, b):
    """a and b cast to their common dtype, as jnp promotes two arrays
    (torch would keep a bf16 a against a 0-d f32 b)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _div(a, b):
    """a / b for a Python float b, divided as jnp divides: b rounded to
    a's dtype (a weak type), then a true division.  (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which can
    differ in the last bit.)"""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _relu(y):
    """jax.nn.relu: max(y, 0)."""
    return torch.maximum(y, torch.zeros_like(y))


# ---------------------------------------------------------------------------
# fake quantisation (QAT) and the scale observers
# ---------------------------------------------------------------------------

def _quantize(x, scale, bits):
    """Symmetric uniform quantisation to ``bits`` (dequantised domain)."""
    bnd = float(2 ** (bits - 1) - 1)
    s = torch.clamp_min(scale, 1e-8)
    x, s = _promote(x, s)
    q = torch.clamp(torch.round(x / s * bnd), -bnd, bnd)
    return _div(q * s, bnd)


def _ste(x, q):
    """x + stop_gradient(q - x): q's value, the identity's gradient."""
    x, q = _promote(x, q)
    return x + (q - x).detach()


@register_op("fake_quantize_abs_max", inputs=("X",),
             outputs=("Out", "OutScale"), attrs={"bit_length": 8})
def fake_quantize_abs_max(ins, attrs, device):
    x = ins["X"]
    scale = torch.amax(torch.abs(x))
    q = _quantize(x, scale, attrs["bit_length"])
    return {"Out": _ste(x, q), "OutScale": scale.reshape((1,))}


@register_op("fake_channel_wise_quantize_abs_max", inputs=("X",),
             outputs=("Out", "OutScale"),
             attrs={"bit_length": 8, "quant_axis": 0})
def fake_channel_wise_quantize_abs_max(ins, attrs, device):
    x = ins["X"]
    ax = attrs["quant_axis"] % x.ndim
    red = tuple(i for i in range(x.ndim) if i != ax)
    scale = torch.amax(torch.abs(x), dim=red, keepdim=True)
    q = _quantize(x, scale, attrs["bit_length"])
    return {"Out": _ste(x, q), "OutScale": scale.reshape(-1)}


@register_op("fake_quantize_moving_average_abs_max",
             inputs=("X", "InScale", "InState", "InAccum"),
             outputs=("Out", "OutScale", "OutState", "OutAccum"),
             optional=("InState", "InAccum"),
             attrs={"bit_length": 8, "moving_rate": 0.9,
                    "is_test": False},
             in_place={"OutScale": "InScale", "OutState": "InState",
                       "OutAccum": "InAccum"})
def fake_quantize_moving_average_abs_max(ins, attrs, device):
    """The bias-corrected EMA of abs-max scales; the scale is floored at
    1e-8 when written (an all-zero batch would otherwise record 0.0,
    which the int8 converter reads as never calibrated)."""
    x = ins["X"]
    in_scale = ins["InScale"].reshape(())
    if attrs["is_test"]:
        q = _quantize(x, in_scale, attrs["bit_length"])
        return {"Out": _ste(x, q), "OutScale": in_scale.reshape((1,)),
                "OutState": ins.get("InState",
                                    torch.ones((1,), dtype=x.dtype,
                                               device=x.device)),
                "OutAccum": ins.get("InAccum", in_scale.reshape((1,)))}
    cur = torch.amax(torch.abs(x)).detach()
    rate = attrs["moving_rate"]
    state = ins.get("InState", torch.ones((1,), dtype=x.dtype,
                                          device=x.device)).reshape(())
    accum = ins.get("InAccum", in_scale.reshape((1,))).reshape(())
    state_out = rate * state + 1.0
    accum_out = torch.add(*_promote(rate * accum, cur))
    scale = torch.clamp_min(torch.div(*_promote(accum_out, state_out)),
                            1e-8)
    q = _quantize(x, scale, attrs["bit_length"])
    return {"Out": _ste(x, q), "OutScale": scale.reshape((1,)),
            "OutState": state_out.reshape((1,)),
            "OutAccum": accum_out.reshape((1,))}


@register_op("fake_dequantize_max_abs", inputs=("X", "Scale"),
             outputs=("Out",), attrs={"max_range": 127.0})
def fake_dequantize_max_abs(ins, attrs, device):
    x, s = _promote(ins["X"].float(), ins["Scale"].reshape(()))
    return {"Out": _div(x * s, attrs["max_range"])}


@register_op("fake_quantize_range_abs_max",
             inputs=("X", "InScale", "Iter"),
             outputs=("Out", "OutScale", "OutScales"),
             optional=("Iter",),
             attrs={"bit_length": 8, "window_size": 10000,
                    "is_test": False})
def fake_quantize_range_abs_max(ins, attrs, device):
    """The running max of abs-max as the scale (the JAX package's
    re-specification of the window bookkeeping); no straight-through
    estimator, as there."""
    x = ins["X"]
    bnd = float(2 ** (attrs["bit_length"] - 1) - 1)
    if attrs["is_test"]:
        scale = ins["InScale"].reshape(())
    else:
        scale = torch.maximum(*_promote(torch.amax(torch.abs(x)),
                                        ins["InScale"].reshape(())))
    scale = torch.clamp_min(scale, 1e-8)
    xs, s = _promote(x, scale)
    q = _div(torch.clamp(torch.round(xs / s * bnd), -bnd, bnd) * s, bnd)
    return {"Out": q, "OutScale": scale.reshape(1),
            "OutScales": scale.reshape(1)}


@register_op("fake_channel_wise_dequantize_max_abs",
             inputs=("X", "Scales"), outputs=("Out",),
             duplicable=("Scales",),
             attrs={"quant_bits": [8], "quant_axis": 0})
def fake_channel_wise_dequantize_max_abs(ins, attrs, device):
    """out = x * prod(scales) / prod(ranges), the first scale along
    quant_axis, the others as scalars."""
    x = ins["X"]
    scales = ins["Scales"]
    bits = attrs["quant_bits"]
    ax = attrs["quant_axis"] % x.ndim
    shape = [1] * x.ndim
    shape[ax] = -1
    out = x.float()
    for s, b in zip(scales, list(bits) + [8] * (len(scales) - len(bits))):
        out, sv = _promote(out, s.reshape(shape))
        out = _div(out * sv, float(2 ** (b - 1) - 1))
        shape = [1] * x.ndim
    return {"Out": out}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             inputs=("X", "InScale", "InAccum", "InState"),
             outputs=("Out", "OutScale", "OutAccum", "OutState"),
             optional=("InAccum", "InState"),
             attrs={"bit_length": 8, "moving_rate": 0.9,
                    "is_test": False})
def fake_quantize_dequantize_moving_average_abs_max(ins, attrs, device):
    """The QAT activation fake-quant; in test mode the moving-average
    state passes through unchanged."""
    x = ins["X"]
    bnd = float(2 ** (attrs["bit_length"] - 1) - 1)
    rate = attrs["moving_rate"]
    cur = torch.amax(torch.abs(x))
    if attrs["is_test"]:
        scale = ins["InScale"].reshape(())
        accum = ins["InAccum"] if ins.get("InAccum") is not None \
            else ins["InScale"]
        state = ins["InState"] if ins.get("InState") is not None \
            else torch.ones_like(ins["InScale"])
    else:
        state0, accum0 = ins.get("InState"), ins.get("InAccum")
        state = state0.reshape(()) * rate + 1.0 if state0 is not None \
            else torch.full((), 1.0, device=x.device)
        if accum0 is not None:
            accum = torch.add(*_promote(accum0.reshape(()) * rate, cur))
        else:
            accum = cur
        scale = torch.div(*_promote(accum, state))
    scale = torch.clamp_min(scale, 1e-8)
    xs, s = _promote(x, scale)
    q = _div(torch.clamp(torch.round(xs / s * bnd), -bnd, bnd) * s, bnd)
    return {"Out": _ste(x, q), "OutScale": scale.reshape(1),
            "OutAccum": torch.reshape(accum, (1,)),
            "OutState": torch.reshape(state, (1,))}


@register_op("moving_average_abs_max_scale",
             inputs=("X", "InAccum", "InState"),
             outputs=("OutScale", "OutAccum", "OutState"),
             optional=("InAccum", "InState"),
             attrs={"moving_rate": 0.9, "is_test": False},
             differentiable=False)
def moving_average_abs_max_scale(ins, attrs, device):
    """The scale observer without quantisation; the scale is floored at
    1e-8 when written."""
    x = ins["X"]
    rate = attrs["moving_rate"]
    cur = torch.amax(torch.abs(x))
    state0, accum0 = ins.get("InState"), ins.get("InAccum")
    state = state0.reshape(()) * rate + 1.0 if state0 is not None \
        else torch.full((), 1.0, device=x.device)
    if accum0 is not None:
        accum = torch.add(*_promote(accum0.reshape(()) * rate, cur))
    else:
        accum = cur
    return {"OutScale": torch.clamp_min(torch.div(*_promote(accum, state)),
                                        1e-8).reshape(1),
            "OutAccum": torch.reshape(accum, (1,)),
            "OutState": torch.reshape(state, (1,))}


# ---------------------------------------------------------------------------
# int8 execution: quantize, dequantize, requantize, dequantize_weight
# ---------------------------------------------------------------------------

@register_op("quantize", inputs=("Input",), outputs=("Output",),
             attrs={"Scale": 1.0, "is_negative_input": True},
             differentiable=False)
def quantize(ins, attrs, device):
    """round(scale * x) as int8 (uint8 when is_negative_input is off)."""
    x = ins["Input"]
    y = torch.round(x * attrs["Scale"])
    if attrs["is_negative_input"]:
        return {"Output": torch.clamp(y, -128, 127).to(torch.int8)}
    return {"Output": torch.clamp(y, 0, 255).to(torch.uint8)}


@register_op("dequantize", inputs=("Input",), outputs=("Output",),
             attrs={"Scale": 1.0}, differentiable=False)
def dequantize(ins, attrs, device):
    return {"Output": _div(ins["Input"].float(), attrs["Scale"])}


@register_op("requantize",
             inputs=("Input", "InScale", "FilterScale", "Bias",
                     "OutScale"),
             outputs=("Output",),
             optional=("InScale", "FilterScale", "Bias", "OutScale"),
             attrs={"Scale_in": 1.0, "Scale_out": 1.0,
                    "max_range": 127.0, "fuse_relu": False,
                    "data_format": "NCHW", "bias_axis": -1,
                    "ref_dtype": "float32"},
             differentiable=False)
def requantize(ins, attrs, device):
    """Without OutScale, int8 rescaled between per-tensor domains by the
    Scale_in/Scale_out attrs.  With it, the fused interlayer epilogue over
    an int32 accumulator: conv2d_int8's dequant order (acc * (sx / bnd^2),
    then the per-channel filter scale), the cast to ref_dtype, the bias
    add with elementwise_add's promotion, relu, and the consumer's
    quantisation (quantize_tail)."""
    x = ins["Input"]
    if "OutScale" not in ins:
        y = x.float() * (attrs["Scale_out"] / attrs["Scale_in"])
        return {"Output": torch.clamp(torch.round(y), -128,
                                      127).to(torch.int8)}
    bnd = attrs["max_range"]
    sx = torch.clamp_min(ins["InScale"].reshape(()).float(), 1e-8)
    y = x.float() * _div(sx, bnd * bnd)
    oscale = ins["FilterScale"].reshape(-1)
    if x.ndim == 4 and attrs["data_format"] == "NCHW":
        sc = oscale.reshape(1, -1, 1, 1)
    else:
        sc = oscale.reshape((1,) * (x.ndim - 1) + (-1,))
    y = torch.mul(*_promote(y, sc))
    y = y.to(to_torch_dtype(attrs.get("ref_dtype", "float32")))
    if "Bias" in ins:
        y, b = _promote(y, _bcast_y(y, ins["Bias"],
                                    attrs.get("bias_axis", -1)))
        y = y + b
    if attrs.get("fuse_relu"):
        y = _relu(y)
    return {"Output": quantize_tail(y, ins["OutScale"], bnd)}


@register_op("dequantize_weight", inputs=("X", "Scale"),
             outputs=("Out",), attrs={"max_range": 127.0},
             differentiable=False)
def dequantize_weight(ins, attrs, device):
    """w = int8 * scale / max_range (the int8-stored weight, dequantised
    where it is read)."""
    x, s = _promote(ins["X"].float(), ins["Scale"])
    return {"Out": _div(x * s, attrs["max_range"])}


# ---------------------------------------------------------------------------
# the s8 convolution: plain version, kernel wrapper, dispatch
# ---------------------------------------------------------------------------

def _epilogue_plain(acc, alpha, colscale, out_dtype, bias, residual, relu,
                    out_scale, bnd):
    """The int8 ops' epilogue on the int32 accumulator ``acc`` (NHWC, or
    [M, N]), in the JAX package's order: ``f32(acc) * alpha``, ``*
    colscale``, the cast to out_dtype, + bias and + residual with
    elementwise_add's promotion, relu, quantize_tail."""
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * alpha.float()
    if colscale is not None:
        y = y * colscale.float()
    y = y.to(out_dtype)
    for operand in (bias, residual):
        if operand is not None:
            y, operand = _promote(y, operand)
            y = y + operand
    if relu:
        y = _relu(y)
    if out_scale is not None:
        y = quantize_tail(y, out_scale, bnd)
    return y


def _conv_acc_plain(x8, w, strides, paddings, dilations, groups):
    """The exact int32 accumulator of the s8 convolution of NHWC ``x8``
    with OIHW ``w``: the im2col columns of x (``F.unfold``, channel-major
    (c, kh, kw) as OIHW is) times each group's filter rows, in f64 (every
    partial sum is an integer below 2^53, so the product is exact)."""
    n, h, wd, c = x8.shape
    cout, cig, kh, kw = w.shape
    (sh, sw), (ph, pw), (dh, dw) = strides, paddings, dilations
    oh = (h + 2 * ph - (kh - 1) * dh - 1) // sh + 1
    ow = (wd + 2 * pw - (kw - 1) * dw - 1) // sw + 1
    cols = F.unfold(x8.permute(0, 3, 1, 2).double(), (kh, kw),
                    dilation=(dh, dw), padding=(ph, pw), stride=(sh, sw))
    cols = cols.reshape(n, groups, cig * kh * kw, oh * ow)
    wg = w.double().reshape(groups, cout // groups, cig * kh * kw)
    acc = torch.matmul(wg.unsqueeze(0), cols)     # [N, G, cog, OH*OW]
    return torch.round(acc).to(torch.int32).reshape(
        n, cout, oh, ow).permute(0, 2, 3, 1)


def conv_int8_plain(x8, w, alpha, colscale=None, bias=None, residual=None,
                    relu=False, out_scale=None, out_dtype=torch.float32,
                    strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
                    groups=1, bnd=127.0):
    """The kernel's function in PyTorch: NHWC int8 ``x8`` convolved with
    the OIHW int8 filter ``w`` into an exact int32 accumulator, then
    ``_epilogue_plain``.  ``alpha`` is the 0-d activation factor, the
    rest as ``conv_int8``; returns NHWC."""
    acc = _conv_acc_plain(x8, w, strides, paddings, dilations, groups)
    return _epilogue_plain(acc, alpha, colscale, out_dtype, bias, residual,
                           relu, out_scale, bnd)


_FILTERS: dict = {}
# the packed stem: a filter row's taps of 4 channels, in rows of 16 bytes
_STEM_CHANNELS = 4


def _kept_filter(w, key, layout, make):
    """``make(w)``, kept per parameter (``key``, the scope's tensor, and
    its version) and layout, so a program's runs lay each filter out
    once."""
    key = w if key is None else key
    hit = _FILTERS.get((id(key), layout))
    if hit is not None and hit[0]() is key and hit[1] == key._version \
            and hit[2].device == w.device:
        return hit[2]
    wk = make(w)
    if len(_FILTERS) > 4096:
        _FILTERS.clear()
    _FILTERS[(id(key), layout)] = (weakref.ref(key), key._version, wk)
    return wk


def _filter_operand(w, key):
    """The kernel's filter: OIHW int8 ``w`` [Cout, cig, KH, KW] as OHWI
    with each group's channels zero-padded to a multiple of 16,
    contiguous, kept per parameter."""
    return _kept_filter(w, key, "ohwi", lambda w: F.pad(
        w.permute(0, 2, 3, 1), (0, -w.shape[1] % _CHUNK)).contiguous())


def _stem_filter_operand(w, key):
    """The packed stem's filter: OIHW ``w`` [Cout, cig <= 4, KH, KW] as
    [Cout, KH, KP], byte 4 kw + c of row kh the tap (kh, kw) of channel
    c, zero past cig and past KW * 4 (KP its multiple of 16); kept per
    parameter."""
    def make(w):
        cout, cig, kh, kw = w.shape
        rows = F.pad(w.permute(0, 2, 3, 1), (0, _STEM_CHANNELS - cig))
        rows = rows.reshape(cout, kh, kw * _STEM_CHANNELS)
        return F.pad(rows, (0, -rows.shape[2] % _CHUNK)).contiguous()

    return _kept_filter(w, key, "stem", make)


def _stem_x_operand(x8, pw):
    """The packed stem's x and width padding: NHWC int8 with its channels
    zero-padded to 4 and its width by pw % 2 zero columns on the left (the
    padding left to the kernel becomes even) and as many on the right as
    make the width even, so each pair of taps the kernel copies lies on 8
    bytes; a copy, counted in ``conv_int8.copies``."""
    left = pw % 2
    right = (x8.shape[2] + left) % 2
    conv_int8.copies += 1
    return F.pad(x8, (0, _STEM_CHANNELS - x8.shape[3], left,
                      right)).contiguous(), pw - left


def kernel_route(cig, groups, strides, dilations):
    """The kernel a convolution takes on the card: "wgmma" for one group
    (a stem of at most 4 channels, unit width dilation and an even width
    stride packed, "wgmma_stem"), "mma_sync" for grouped ones."""
    if groups != 1:
        return "mma_sync"
    if cig <= _STEM_CHANNELS and dilations[1] == 1 and strides[1] % 2 == 0:
        return "wgmma_stem"
    return "wgmma"


_ROUTE_CODES = {"mma_sync": 0, "wgmma": 1, "wgmma_stem": 2}


def _x_operand(x8, groups):
    """NHWC int8 x with each group's channels zero-padded to a multiple of
    16 and rows on 16 bytes; a copy where needed, counted in
    ``conv_int8.copies``."""
    n, h, wd, c = x8.shape
    cig = c // groups
    pad = -cig % _CHUNK
    if pad:
        conv_int8.copies += 1
        return F.pad(x8.reshape(n, h, wd, groups, cig),
                     (0, pad)).reshape(n, h, wd, groups * (cig + pad))
    if not x8.is_contiguous() or x8.data_ptr() % 16:
        conv_int8.copies += 1
        return x8.clone(memory_format=torch.contiguous_format)
    return x8


def _load():
    from paddle_tpu_torch import _build

    lib = _build.load(_KERNEL)
    if lib.pt_conv_int8.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pt_conv_int8.argtypes = ([ptr] * 8 + [i32] * 23
                                     + [ctypes.c_float, ptr])
        lib.pt_conv_int8.restype = i32
        lib.pt_cuda_error_string.argtypes = [i32]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _vector(name, t, n, device):
    """t as a contiguous [n] f32/bf16 vector on device (None stays)."""
    if t is None:
        return None
    t = t.reshape(-1)
    if t.numel() != n or t.dtype not in _OPERAND_CODES or \
            t.device != device:
        raise ValueError(f"conv_int8: {name} must be a float32/bfloat16 "
                         f"[{n}] tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _launch(x8, w, alpha, colscale, bias, residual, relu, out_scale,
            out_dtype, strides, paddings, dilations, groups, bnd, w_key,
            route):
    if x8.dtype != torch.int8 or w.dtype != torch.int8 or x8.dim() != 4 \
            or w.dim() != 4:
        raise TypeError(f"conv_int8: x8 must be NHWC int8 and w OIHW "
                        f"int8, got {x8.dtype} {tuple(x8.shape)} and "
                        f"{w.dtype} {tuple(w.shape)}")
    n, h, wd, c = x8.shape
    cout, cig, kh, kw = w.shape
    if c != groups * cig or cout % groups:
        raise ValueError(f"conv_int8: x {tuple(x8.shape)} does not match "
                         f"the filter {tuple(w.shape)} in {groups} groups")
    (sh, sw), (ph, pw), (dh, dw) = strides, paddings, dilations
    oh = (h + 2 * ph - (kh - 1) * dh - 1) // sh + 1
    ow = (wd + 2 * pw - (kw - 1) * dw - 1) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError("conv_int8: the padded input is smaller than the "
                         "dilated filter")
    dev = x8.device
    dt = out_dtype
    for operand in (bias, residual):
        if operand is not None:
            dt = torch.promote_types(dt, operand.dtype)
    if out_dtype == torch.int32:
        dt = torch.int32
    elif out_scale is not None:
        dt = torch.int8
    if dt not in _OUT_CODES or (out_dtype != torch.int32
                                and out_dtype not in _OPERAND_CODES):
        raise TypeError(f"conv_int8: out_dtype {out_dtype} (result {dt}) "
                        "is not float32, bfloat16 or int32")
    auto = kernel_route(cig, groups, strides, dilations)
    route = auto if route is None else route
    if route not in _ROUTE_CODES or (route != auto and route != "mma_sync"):
        raise ValueError(f"conv_int8: route {route!r} does not take this "
                         f"convolution (it takes {auto!r} or 'mma_sync')")
    pw_k = pw
    if route == "wgmma_stem":
        (xk, pw_k), wk = _stem_x_operand(x8, pw), _stem_filter_operand(
            w, w_key)
    else:
        xk, wk = _x_operand(x8, groups), _filter_operand(w, w_key)
    cig_k = _STEM_CHANNELS if route == "wgmma_stem" else wk.shape[3]
    alpha = alpha.reshape(1).float().contiguous()
    colscale = None if colscale is None else \
        colscale.float().reshape(-1).expand(cout).contiguous()
    bias = _vector("bias", bias, cout, dev)
    if residual is not None:
        if tuple(residual.shape) != (n, oh, ow, cout) or \
                residual.dtype not in _OPERAND_CODES or \
                residual.device != dev:
            raise ValueError(f"conv_int8: residual must be a float32/"
                             f"bfloat16 {(n, oh, ow, cout)} tensor on {dev}, "
                             f"got {tuple(residual.shape)} {residual.dtype}")
        residual = residual.contiguous()
    so = None if out_scale is None else torch.clamp_min(
        out_scale.reshape(()).float(), 1e-8).reshape(1)
    out = torch.empty((n, oh, ow, cout), dtype=dt, device=dev)
    if out.numel() == 0:
        return out
    lib = _load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    def code(t):
        return -1 if t is None else _OPERAND_CODES[t.dtype]

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pt_conv_int8(
            xk.data_ptr(), wk.data_ptr(), alpha.data_ptr(), ptr(colscale),
            ptr(bias), ptr(residual), ptr(so), out.data_ptr(),
            n, h, xk.shape[2], xk.shape[3], cout, kh, kw, cig_k, groups,
            sh, sw, ph, pw_k, dh, dw, oh, ow,
            _OUT_CODES[dt],
            _OUT_CODES[out_dtype] if out_dtype != torch.int32 else 0,
            code(bias), code(residual), int(bool(relu)),
            _ROUTE_CODES[route], float(bnd), stream)
    if err != 0:
        raise RuntimeError("conv_int8 kernel launch failed: "
                           + lib.pt_cuda_error_string(err).decode())
    conv_int8.launches += 1
    conv_int8.launches_by_route[route] += 1
    return out


def conv_int8(x8, w, alpha, colscale=None, bias=None, residual=None,
              relu=False, out_scale=None, out_dtype=torch.float32,
              strides=(1, 1), paddings=(0, 0), dilations=(1, 1), groups=1,
              bnd=127.0, w_key=None, route=None):
    """The s8 convolution with the int8 epilogue: NHWC int8 ``x8``, OIHW
    int8 ``w`` [Cout, Cin/groups, KH, KW], the 0-d f32 activation factor
    ``alpha`` (conv2d_int8: sx / bnd^2; mul_int8: sx / bnd), the
    per-channel factor ``colscale`` (the filter scale; mul_int8's post
    factor, or None), f32/bf16 ``bias`` [Cout] and ``residual`` (NHWC),
    ``relu``, ``out_scale`` (the requantize stage: int8 out) and
    ``out_dtype`` (float32 or bfloat16; int32 returns the accumulator).
    Both ops round as (f32(acc) * alpha) * colscale.  ``w_key`` is the
    parameter the filter came from (its kernel layout is kept per
    parameter).  A CUDA tensor launches ``csrc/conv_int8.cu`` on the
    route ``kernel_route`` picks (``route="mma_sync"`` asks for the first
    kernel, which every convolution takes); a CPU or meta tensor takes
    ``conv_int8_plain``.  Returns NHWC."""
    args = (alpha, colscale, bias, residual, relu, out_scale, out_dtype,
            _pair(strides), _pair(paddings), _pair(dilations), groups, bnd)
    if x8.device.type == "cuda":
        return _launch(x8, w, *args, w_key, route)
    if x8.device.type in ("cpu", "meta"):
        return conv_int8_plain(x8, w, *args)
    raise ValueError(f"conv_int8: no implementation for {x8.device}")


conv_int8.launches = 0
conv_int8.launches_by_route = dict.fromkeys(_ROUTE_CODES, 0)
conv_int8.copies = 0


# ---------------------------------------------------------------------------
# conv2d_int8 and mul_int8
# ---------------------------------------------------------------------------

def _in_scale(ins):
    return torch.clamp_min(ins["InScale"].reshape(()).float(), 1e-8)


def quantize_act_plain(x, sx, bnd):
    """clip(round(f32(x) / sx * bnd), -bnd, bnd) as int8: a true division
    by the 0-d ``sx`` on x's device, then a product, each rounded."""
    return torch.clamp(torch.round(x.float() / sx * bnd), -bnd,
                       bnd).to(torch.int8)


_QUANT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dense(t):
    """Whether t's elements fill its storage span once, in some order of
    its dims (contiguous, channels-last, any permutation of either)."""
    expect = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape)
                               if n != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _quantize_launch(x, sx, bnd):
    if x.dtype not in _QUANT_CODES:
        raise TypeError(f"quantize_act: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    sx = sx.reshape(())
    if sx.dtype != torch.float32 or sx.device != x.device:
        raise ValueError(f"quantize_act: sx must be a float32 scalar on "
                         f"{x.device}, got {sx.dtype} on {sx.device}")
    if not _dense(x):
        quantize_act.copies += 1
        x = x.contiguous()
    # x's own strides: the kernel maps storage to storage
    out = torch.empty_like(x, dtype=torch.int8)
    if out.numel() == 0:
        return out
    from paddle_tpu_torch import _build

    lib = _build.load("quantize_act")
    if lib.pt_quantize_act.argtypes is None:
        ptr = ctypes.c_void_p
        lib.pt_quantize_act.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_float, ptr]
        lib.pt_quantize_act.restype = ctypes.c_int
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    sx = sx.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_quantize_act(x.data_ptr(), out.data_ptr(),
                                  sx.data_ptr(), x.numel(),
                                  _QUANT_CODES[x.dtype], float(bnd), stream)
    if err != 0:
        raise RuntimeError("quantize_act kernel launch failed: "
                           + lib.pt_cuda_error_string(err).decode())
    quantize_act.launches += 1
    return out


def quantize_act(x, sx, bnd):
    """The activation's per-tensor quantisation of ``conv2d_int8`` and
    ``mul_int8``: int8 x of x's shape, ``quantize_act_plain``'s function.
    A CUDA tensor (f32 or bf16, any view) launches
    ``csrc/quantize_act.cu`` with ``sx`` read on the card; a CPU or meta
    tensor takes ``quantize_act_plain``."""
    if x.device.type == "cuda":
        return _quantize_launch(x, sx, bnd)
    if x.device.type in ("cpu", "meta"):
        return quantize_act_plain(x, sx, bnd)
    raise ValueError(f"quantize_act: no implementation for {x.device}")


quantize_act.launches = 0
quantize_act.copies = 0


def _channel_bias(ins, attrs, y_ndim, channel_axis):
    """The Bias operand, which the kernel adds along the channel axis:
    elementwise_add's broadcast (``bias_axis``) must put it there."""
    b = ins.get("Bias")
    if b is None:
        return None
    axis = attrs.get("bias_axis", -1)
    start = y_ndim - b.ndim if axis == -1 else axis
    if b.ndim != 1 or start != channel_axis:
        raise ValueError(f"int8 op: Bias {tuple(b.shape)} with bias_axis "
                         f"{axis} does not broadcast along the channel axis "
                         f"{channel_axis} of the output")
    return b


@register_op("conv2d_int8", inputs=("Input", "Filter", "FilterScale",
                                    "InScale", "Bias", "Residual",
                                    "OutScale"),
             outputs=("Output",),
             optional=("InScale", "Bias", "Residual", "OutScale"),
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1,
                    "data_format": "NCHW", "max_range": 127.0,
                    "out_dtype": "float32", "fuse_relu": False,
                    "bias_axis": -1, "epilogue": ""},
             differentiable=False)
def conv2d_int8(ins, attrs, device):
    """The true-int8 convolution: x quantised per tensor (the calibrated
    InScale, or max|x|; an int8 x is taken as the producer quantised it,
    which needs InScale), the s8 convolution into int32, then
    ``(f32(acc) * (sx / bnd^2)) * filter_scale``, the cast to out_dtype,
    Bias, Residual, relu and the OutScale requantize stage
    (``conv_int8``); out_dtype "int32" returns the raw accumulator."""
    x, q, ws = ins["Input"], ins["Filter"], ins["FilterScale"]
    bnd = attrs["max_range"]
    if x.dtype == torch.int8:
        if "InScale" not in ins:
            raise ValueError(
                "conv2d_int8: int8 input requires a calibrated InScale "
                "(the producer quantized to it); dynamic scaling of an "
                "already-quantized tensor is ill-defined")
        sx = _in_scale(ins)
        x8 = x
    else:
        if "InScale" in ins:
            sx = _in_scale(ins)
        else:
            sx = torch.clamp_min(torch.amax(torch.abs(x)), 1e-8)
        x8 = quantize_act(x, sx, bnd)
    nchw = attrs.get("data_format", "NCHW") == "NCHW"
    if nchw:
        x8 = x8.permute(0, 2, 3, 1)
    residual = ins.get("Residual")
    if residual is not None and nchw:
        residual = residual.permute(0, 2, 3, 1)
    bias = _channel_bias(ins, attrs, 4, 1 if nchw else 3)
    out_dtype = to_torch_dtype(attrs["out_dtype"])
    y = conv_int8(x8, q, _div(sx, bnd * bnd), ws.reshape(-1), bias,
                  residual,
                  attrs.get("fuse_relu", False), ins.get("OutScale"),
                  out_dtype, attrs["strides"], attrs["paddings"],
                  attrs["dilations"], attrs["groups"], bnd, w_key=q)
    if nchw:
        y = y.permute(0, 3, 1, 2).contiguous()
    return {"Output": y}


@register_op("mul_int8", inputs=("X", "Y", "Scale", "InScale", "Bias",
                                 "OutScale"),
             outputs=("Out",), optional=("InScale", "Bias", "OutScale"),
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1,
                    "max_range": 127.0, "out_dtype": "float32",
                    "fuse_relu": False, "bias_axis": -1,
                    "epilogue": ""},
             differentiable=False)
def mul_int8(ins, attrs, device):
    """The true-int8 mul: x quantised per tensor, an s8 x s8 product into
    int32, then ``f32(acc) * (sx / bnd)``, ``* post``, the cast, Bias,
    relu and OutScale.  Weight scale conventions (w ~= q * scale / bnd),
    decided by the scale's shape: (K, 1) per input row, folded into x
    before quantisation; (1, N) per output column, applied after; size 1
    per tensor; a 1-D scale by its size (the row convention wins on a
    square weight).  Per-row scales are refused with an int8 x or an
    int32 out (interlayer execution)."""
    x, q, ws = ins["X"], ins["Y"], ins["Scale"]
    bnd = attrs["max_range"]
    xnc, ync = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    x2 = x.reshape((int(np.prod(x.shape[:xnc])), -1))
    q2 = q.reshape((int(np.prod(q.shape[:ync])), -1))
    k, n = q2.shape
    if ws.numel() == 1:
        per_row = per_col = False
    elif ws.ndim >= 2 and int(np.prod(ws.shape[1:])) == 1:
        per_row, per_col = True, False
    elif ws.ndim >= 2 and ws.shape[0] == 1:
        per_row, per_col = False, True
    else:
        per_row = ws.numel() == k
        per_col = not per_row and ws.numel() == n
    ws2 = ws.reshape(-1)
    post = None
    if per_row:
        x2 = torch.mul(*_promote(x2, _div(ws2, bnd).reshape(1, k)))
    elif per_col:
        post = _div(ws2, bnd)
    else:
        post = _div(ws2.reshape(()), bnd)
    out_dtype = to_torch_dtype(attrs["out_dtype"])
    if (x.dtype == torch.int8 or out_dtype == torch.int32) and per_row:
        raise ValueError(
            "mul_int8: per-input-row weight scales are incompatible "
            "with int8-in/int32-out interlayer execution (the row "
            "scale folds into the activation pre-quantization)")
    if x.dtype == torch.int8:
        if "InScale" not in ins:
            raise ValueError(
                "mul_int8: int8 input requires a calibrated InScale "
                "(the producer quantized to it)")
        sx = _in_scale(ins)
        x8 = x2
    else:
        if "InScale" in ins:
            cal = _in_scale(ins)
            sx = _div(cal * torch.amax(ws2).float(), bnd) if per_row \
                else cal
        else:
            sx = torch.clamp_min(torch.amax(torch.abs(x2)), 1e-8)
        x8 = quantize_act(x2, sx, bnd)
    out_shape = tuple(x.shape[:xnc]) + tuple(q.shape[ync:])
    bias = _channel_bias(ins, attrs, len(out_shape), len(out_shape) - 1)
    y = conv_int8(x8.reshape(x8.shape[0], 1, 1, k),
                  q2.t().reshape(n, k, 1, 1), _div(sx, bnd), post, bias,
                  None,
                  attrs.get("fuse_relu", False), ins.get("OutScale"),
                  out_dtype, w_key=q)
    return {"Out": y.reshape(out_shape)}
