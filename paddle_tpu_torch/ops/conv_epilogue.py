"""Fused convolution epilogues: conv + bias + residual + act, and the
conv + train-mode batch-norm chain.

Counterpart of ``paddle_tpu/ops/pallas_conv.py``.  Activations are NHWC,
filters OIHW, as there.  Three TPU kernels are replaced by kernels
written for Hopper:

- ``_conv_ep_kernel`` (``:99``): ``act(conv(x, w) + bias + residual)``,
  one f32 accumulator, one cast.  Here ``csrc/conv_epilogue.cu``
  (``pt_conv_epilogue``), an implicit GEMM (bf16 on wgmma); wrapper
  ``conv_epilogue_kernel``, launches counted in
  ``conv_epilogue_kernel.launches``.  The wrapper hands the kernel the
  filter as OHWI, the GEMM's K-major ``[Cout, K]`` operand, and in bf16
  x with whole 16-byte chunks (``_kernel_operands``).
- ``_conv_stats_kernel`` (``:311``): the same conv (+ bias) that also
  returns per-channel partial sums of y and y*y of the output after its
  cast.  The same source with the statistics enabled; wrapper
  ``conv_stats_kernel`` (``conv_stats_kernel.launches``).  Its partials
  are one row per 128-pixel tile of the output, written without atomics;
  PyTorch sums them and ``_finalize_stats`` turns them into mean and
  variance.  The plain version gives one row per image, as the Pallas
  kernel does; the sum over rows is the same quantity.
- ``_bn_apply_kernel`` (``:484``): ``act(((y - mean) * rstd) * scale +
  shift, cast to y's dtype, + residual)``.  Here ``csrc/bn_apply.cu``;
  wrapper ``bn_apply_kernel`` (``bn_apply_kernel.launches``).

What the Pallas wrappers did for the TPU alone is gone: the pad of x
before the call (the CUDA kernel masks its loads), the VMEM-budget
fall-backs (every shape goes to the kernel), the sublane-replicated
statistics blocks and the 256-wide Cout blocks.

Each kernel has a plain PyTorch version beside it (``*_plain``): the tap
loop of products in f32, as the Pallas body runs it, and
``_bn_apply_xla``'s order.  A wrapper takes it for a CPU or ``meta``
tensor; on a CUDA tensor it launches the kernel or raises.

Implementations (``impl``), as in ``ops/epilogue.py``:

  ``"xla"``        the unfused composite (flags ``off`` and ``xla``)
  ``"interpret"``  the kernels' plain versions, on any device
  ``"pallas"``     the CUDA kernels; a CPU tensor raises
  ``None``         (flag ``on``) the kernels on a CUDA tensor, the
                   composite on a CPU one

The gradients are ``torch.autograd.Function``s that mirror the JAX
package's ``custom_vjp``s: the relu is masked by the saved output (so
its gradient at 0 is 0), the BN backward is the closed form on the saved
batch statistics, and dx and dw are PyTorch's convolution gradients, as
the JAX package takes XLA's.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.epilogue import (apply_acc_stages, apply_bn_tail,
                                           apply_chain_stages)
from paddle_tpu_torch.ops.nn import _moments_1pass, conv_nd

_CONV_LIB = "conv_epilogue"
_BN_LIB = "bn_apply"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# shapes and the plain convolution
# ---------------------------------------------------------------------------

def _norm_padding(paddings):
    """[ph, pw] or ((ph0, ph1), (pw0, pw1)) -> ((ph0, ph1), (pw0, pw1))."""
    p = tuple(paddings)
    if len(p) == 2 and not isinstance(p[0], (tuple, list)):
        return ((int(p[0]), int(p[0])), (int(p[1]), int(p[1])))
    return tuple((int(a), int(b)) for a, b in p)


def _out_spatial(h, w, kh, kw, sh, sw, padding):
    (ph0, ph1), (pw0, pw1) = padding
    return (h + ph0 + ph1 - kh) // sh + 1, (w + pw0 + pw1 - kw) // sw + 1


def _padded(x, padding):
    """(x, torch padding) for F.conv2d: x padded explicitly where the
    padding is not symmetric."""
    (ph0, ph1), (pw0, pw1) = padding
    if ph0 == ph1 and pw0 == pw1:
        return x, (ph0, pw0)
    return F.pad(x, (0, 0, pw0, pw1, ph0, ph1)), (0, 0)


def _conv_core(x, w, strides, padding):
    """The plain NHWC convolution with OIHW filters: what the unfused
    graph runs (``paddle_tpu/ops/pallas_conv.py:72``)."""
    xp, pad = _padded(x, padding)
    return conv_nd(xp, w, strides, pad, fmt="NHWC")


def _conv_grads(g, x, w, strides, padding):
    """dx (NHWC) and dw (OIHW) of ``_conv_core`` at x, w for the
    cotangent g: PyTorch's convolution backward, with no forward."""
    xp, pad = _padded(x, padding)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), w, None,
        list(strides), list(pad), [1, 1], False, [0, 0], 1,
        [True, True, False])
    dx = dx.permute(0, 2, 3, 1)
    if xp is not x:
        (ph0, _), (pw0, _) = padding
        dx = dx[:, ph0:ph0 + x.shape[1], pw0:pw0 + x.shape[2]]
    return dx, dw


def _reference(x, w, bias, residual, strides, padding, act):
    """The unfused chain: conv, then each add in the conv's dtype, then
    the act (flags ``off`` and ``xla``)."""
    return apply_chain_stages(_conv_core(x, w, strides, padding),
                              bias=bias, residual=residual, act=act)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

def _conv_acc(x, w, strides, padding):
    """The Pallas body's tap loop: for each filter tap (i, j), the strided
    [N*OH*OW, Cin] patch of the padded input times w[:, :, i, j]^T,
    summed into an f32 accumulator in tap order.  Returns (acc [M, O],
    (N, OH, OW, O))."""
    n, h, wd, cin = x.shape
    cout, _, kh, kw = w.shape
    sh, sw = strides
    oh, ow = _out_spatial(h, wd, kh, kw, sh, sw, padding)
    (ph0, _), (pw0, _) = padding
    hp, wp = (oh - 1) * sh + kh, (ow - 1) * sw + kw
    xp = F.pad(x.float(), (0, 0, pw0, max(wp - wd - pw0, 0),
                           ph0, max(hp - h - ph0, 0)))[:, :hp, :wp]
    w_hwio = w.float().permute(2, 3, 1, 0)
    acc = torch.zeros((n * oh * ow, cout), dtype=torch.float32,
                      device=x.device)
    for ti in range(kh):
        for tj in range(kw):
            p = xp[:, ti:ti + (oh - 1) * sh + 1:sh,
                   tj:tj + (ow - 1) * sw + 1:sw]
            acc = acc + torch.matmul(p.reshape(-1, cin), w_hwio[ti, tj])
    return acc, (n, oh, ow, cout)


def conv_epilogue_plain(x, w, bias=None, residual=None, strides=(1, 1),
                        padding=((0, 0), (0, 0)), act=""):
    """#5's function: the tap loop into an f32 accumulator, bias,
    residual and act on it (``apply_acc_stages``), one cast to
    ``promote(x, w)``."""
    acc, shape = _conv_acc(x, w, strides, padding)
    acc = apply_acc_stages(
        acc, bias=bias,
        residual=None if residual is None else residual.reshape(
            acc.shape), act=act)
    return acc.to(torch.promote_types(x.dtype, w.dtype)).reshape(shape)


def conv_stats_plain(x, w, bias=None, strides=(1, 1),
                     padding=((0, 0), (0, 0))):
    """#6's function: y = cast(conv + bias) and, per image, the f32 sums
    of y and y*y over its pixels, taken after the cast: (y, s1 [N, O],
    s2 [N, O])."""
    acc, shape = _conv_acc(x, w, strides, padding)
    acc = apply_acc_stages(acc, bias=bias)
    y = acc.to(torch.promote_types(x.dtype, w.dtype)).reshape(shape)
    yf = y.float().reshape(shape[0], -1, shape[3])
    return y, torch.sum(yf, dim=1), torch.sum(yf * yf, dim=1)


def bn_apply_plain(y, mean, rstd, scale, shift, residual=None, act=""):
    """#7's function, ``_bn_apply_xla``'s order: normalise, scale and
    shift in f32, cast to y's dtype, add the residual in that dtype, act
    last."""
    t = (y.float() - mean.float()) * rstd.float()
    t = t * scale.float() + shift.float()
    return apply_bn_tail(t, y.dtype, residual, act)


def _conv_stats_xla(x, w, bias, strides, padding):
    """The composite with #6's statistics: plain conv (+ bias), then the
    per-image sums of the cast output."""
    y = _conv_core(x, w, strides, padding)
    if bias is not None:
        y = y + bias.to(y.dtype)
    yf = y.float()
    return y, torch.sum(yf, dim=(1, 2)), torch.sum(yf * yf, dim=(1, 2))


def _finalize_stats(s1, s2, m):
    """Partial sums [rows, C] -> per-channel (mean, var), f32, by raw
    moments: var = E[y^2] - mean^2, clamped at 0
    (``paddle_tpu/ops/pallas_conv.py:446-455``)."""
    mean = torch.sum(s1, dim=0) / m
    e2 = torch.sum(s2, dim=0) / m
    var = e2 - mean * mean
    return mean, torch.maximum(var, torch.zeros_like(var))


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

def _load(name, fn, n_ptrs, n_ints):
    """The loaded library of ``csrc/<name>.cu`` (built at first use) with
    ``fn``'s argument types set: n_ptrs pointers, n_ints ints, the
    stream."""
    from paddle_tpu_torch import _build

    lib = _build.load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [ptr] * n_ptrs + [i32] * n_ints + [ptr]
        f.restype = i32
        lib.pt_cuda_error_string.argtypes = [i32]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def stats_tile_m():
    """The output rows (N*OH*OW pixels) of one tile of the CUDA conv
    kernel, as the built library reports it: the statistics partials have
    one row per tile."""
    return _load(_CONV_LIB, "pt_conv_epilogue", 7, 18).pt_conv_tile_m()


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.pt_cuda_error_string(err).decode())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _code(t):
    return -1 if t is None else _DTYPE_CODES[t.dtype]


def _check_vector(name, t, c, device):
    if t is None:
        return
    if tuple(t.shape) != (c,) or t.dtype not in _DTYPE_CODES or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32/bfloat16 "
                         f"[{c}] tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _aligned(t):
    """t, or a copy of it where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_operands(x, w, strides, padding, out_w):
    """(x, w, strides, (ph, pw)) as the kernel takes them: x NHWC
    contiguous; w OHWI ``[Cout, KH, KW, Cin]``, the GEMM's K-major
    ``[Cout, K]`` operand with k = (kh * KW + kw) * Cin + c (for a 1x1
    filter OIHW already is that layout, so no copy); the top and left
    padding.  In bf16 the kernel copies 8 channels of one tap at a time,
    so Cin is padded with zero channels to a multiple of 8, and a
    misaligned view is copied.  A narrow input with an even horizontal
    stride (the 3-channel stem, 7x7 stride 2) instead gets 4 channels,
    its left padding made explicit, and is read as pixels of 8 channels
    that pair each even column with the next: the stride halves, KW rounds
    up to even with a zero tap, and each 16-byte copy carries two taps.
    Zero channels and taps add zero products, so neither y nor its
    statistics change."""
    x = x.contiguous()
    w = w.permute(0, 2, 3, 1)
    (ph0, _), (pw0, _) = padding
    sh, sw = strides
    if x.dtype != torch.bfloat16:
        return x, w.contiguous(), (sh, sw), (ph0, pw0)
    n, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    if cin <= 4 and sw % 2 == 0:
        kw2 = kw + kw % 2
        wp = max(wd + pw0, (out_w - 1) * sw + kw2)
        wp += wp % 2
        x = F.pad(x, (0, 4 - cin, pw0, wp - wd - pw0)).view(n, h, wp // 2, 8)
        w = F.pad(w, (0, 4 - cin, 0, kw2 - kw)).reshape(cout, kh, kw2 // 2, 8)
        return x, w, (sh, sw // 2), (ph0, 0)
    pad = -cin % 8
    if pad:
        x, w = F.pad(x, (0, pad)), F.pad(w, (0, pad))
    return _aligned(x), _aligned(w.contiguous()), (sh, sw), (ph0, pw0)


def _conv_launch(x, w, bias, residual, strides, padding, act, stats):
    ct = torch.promote_types(x.dtype, w.dtype)
    if ct not in _DTYPE_CODES:
        raise TypeError(f"conv kernel: x and w must be float32 or "
                        f"bfloat16, got {x.dtype}/{w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[1]:
        raise ValueError(f"conv kernel: x {tuple(x.shape)} is not NHWC "
                         f"for the OIHW filter {tuple(w.shape)}")
    n, h, wd, _ = x.shape
    cout, _, kh, kw = w.shape
    oh, ow = _out_spatial(h, wd, kh, kw, *strides, padding)
    if oh <= 0 or ow <= 0:
        raise ValueError("conv kernel: the padded input is smaller than "
                         "the filter")
    x, w_k, (sh, sw), (ph0, pw0) = _kernel_operands(
        x.to(ct), w.to(ct), strides, padding, ow)
    _, h, wd, cin = x.shape
    _, kh, kw, _ = w_k.shape
    _check_vector("bias", bias, cout, x.device)
    if residual is not None:
        if tuple(residual.shape) != (n, oh, ow, cout) or \
                residual.dtype not in _DTYPE_CODES or \
                residual.device != x.device:
            raise ValueError(f"residual must be a float32/bfloat16 "
                             f"{(n, oh, ow, cout)} tensor on {x.device}, "
                             f"got {tuple(residual.shape)} "
                             f"{residual.dtype}")
        residual = residual.contiguous()
    lib = _load(_CONV_LIB, "pt_conv_epilogue", 7, 18)
    out = torch.empty((n, oh, ow, cout), dtype=ct, device=x.device)
    s1 = s2 = None
    tiles = -(-n * oh * ow // lib.pt_conv_tile_m())
    if stats:
        s1 = torch.empty((tiles, cout), dtype=torch.float32,
                         device=x.device)
        s2 = torch.empty_like(s1)
    if out.numel() == 0:
        return out, s1, s2
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_conv_epilogue(
            x.data_ptr(), w_k.data_ptr(), _ptr(bias), _ptr(residual),
            out.data_ptr(), _ptr(s1), _ptr(s2),
            n, h, wd, cin, cout, kh, kw, sh, sw, ph0, pw0, oh, ow,
            _DTYPE_CODES[ct], _code(bias), _code(residual),
            1 if act == "relu" else 0, tiles, stream)
    _raise_on(lib, err, "conv_stats" if stats else "conv_epilogue")
    return out, s1, s2


def _check_act(act):
    if act not in ("", "relu"):
        raise ValueError(f"conv kernels: unknown activation {act!r}")


def conv_epilogue_kernel(x, w, bias=None, residual=None, strides=(1, 1),
                         padding=((0, 0), (0, 0)), act=""):
    """#5's wrapper: a CUDA tensor launches ``csrc/conv_epilogue.cu`` (a
    build or launch failure raises), a CPU or meta tensor takes
    ``conv_epilogue_plain``."""
    _check_act(act)
    if x.device.type == "cuda":
        out = _conv_launch(x, w, bias, residual, strides, padding, act,
                           False)[0]
        conv_epilogue_kernel.launches += 1
        return out
    if x.device.type in ("cpu", "meta"):
        return conv_epilogue_plain(x, w, bias, residual, strides, padding,
                                   act)
    raise ValueError(f"conv_epilogue: no implementation for {x.device}")


def conv_stats_kernel(x, w, bias=None, strides=(1, 1),
                      padding=((0, 0), (0, 0))):
    """#6's wrapper: (y, s1, s2).  On a CUDA tensor the partials are one
    row per ``stats_tile_m()`` output pixels; a CPU or meta tensor takes
    ``conv_stats_plain`` (one row per image)."""
    if x.device.type == "cuda":
        out = _conv_launch(x, w, bias, None, strides, padding, "", True)
        conv_stats_kernel.launches += 1
        return out
    if x.device.type in ("cpu", "meta"):
        return conv_stats_plain(x, w, bias, strides, padding)
    raise ValueError(f"conv_stats: no implementation for {x.device}")


def bn_apply_kernel(y, mean, rstd, scale, shift, residual=None, act=""):
    """#7's wrapper: a CUDA tensor launches ``csrc/bn_apply.cu``, a CPU
    or meta tensor takes ``bn_apply_plain``."""
    _check_act(act)
    if y.device.type in ("cpu", "meta"):
        return bn_apply_plain(y, mean, rstd, scale, shift, residual, act)
    if y.device.type != "cuda":
        raise ValueError(f"bn_apply: no implementation for {y.device}")
    if y.dim() != 4 or y.dtype not in _DTYPE_CODES:
        raise ValueError(f"bn_apply: y must be a float32/bfloat16 NHWC "
                         f"tensor, got {tuple(y.shape)} {y.dtype}")
    c = y.shape[3]
    vecs = [v.float().contiguous() for v in (mean, rstd, scale, shift)]
    for name, v in zip(("mean", "rstd", "scale", "shift"), vecs):
        _check_vector(name, v, c, y.device)
    y = y.contiguous()
    if residual is not None:
        if residual.shape != y.shape or residual.dtype not in \
                _DTYPE_CODES or residual.device != y.device:
            raise ValueError(f"bn_apply: residual {tuple(residual.shape)} "
                             f"{residual.dtype} does not match y")
        residual = residual.contiguous()
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out
    lib = _load(_BN_LIB, "pt_bn_apply", 7, 5)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.pt_bn_apply(
            y.data_ptr(), *(v.data_ptr() for v in vecs), _ptr(residual),
            out.data_ptr(), y.numel() // c, c, _DTYPE_CODES[y.dtype],
            _code(residual), 1 if act == "relu" else 0, stream)
    _raise_on(lib, err, "bn_apply")
    bn_apply_kernel.launches += 1
    return out


conv_epilogue_kernel.launches = 0
conv_stats_kernel.launches = 0
bn_apply_kernel.launches = 0


# ---------------------------------------------------------------------------
# conv2d_epilogue: the autograd Function and the public entry
# ---------------------------------------------------------------------------

def _resolve(impl, x, what):
    """impl None picks the kernel on a CUDA tensor and the composite
    elsewhere; 'pallas' on a CPU tensor raises."""
    if impl is None:
        return "pallas" if x.device.type == "cuda" else "xla"
    if impl == "pallas" and x.device.type == "cpu":
        raise ValueError(f"{what}: impl 'pallas' runs the CUDA kernels and "
                         "was given a CPU tensor; use 'interpret' or 'xla' "
                         "on the CPU")
    if impl not in ("pallas", "interpret", "xla"):
        raise ValueError(f"{what}: unknown impl {impl!r}")
    return impl


class ConvEpilogue(torch.autograd.Function):
    """``act(conv(x, w) + bias + residual)``; the backward mirrors
    ``_conv_ep_bwd`` (``paddle_tpu/ops/pallas_conv.py:262-282``)."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, strides, padding, act, impl):
        impl = _resolve(impl, x, "conv2d_epilogue")
        if impl == "pallas":
            y = conv_epilogue_kernel(x, w, bias, residual, strides,
                                     padding, act)
        elif impl == "interpret":
            y = conv_epilogue_plain(x, w, bias, residual, strides, padding,
                                    act)
        else:
            y = _reference(x, w, bias, residual, strides, padding, act)
        ctx.save_for_backward(x, w, bias, residual, y)
        ctx.strides, ctx.padding, ctx.act = strides, padding, act
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, bias, residual, y = ctx.saved_tensors
        gf = g
        if ctx.act == "relu":
            # y is post-relu: y > 0 exactly where the pre-activation is
            gf = torch.where(y > 0, g, torch.zeros_like(g))
        ct = torch.promote_types(x.dtype, w.dtype)
        dx, dw = _conv_grads(gf.to(ct), x, w, ctx.strides, ctx.padding)
        db = None if bias is None else torch.sum(
            gf.float(), dim=(0, 1, 2)).to(bias.dtype)
        dres = None if residual is None else gf.to(residual.dtype)
        return dx, dw, db, dres, None, None, None, None


def conv2d_epilogue(x, w, bias=None, residual=None, *, strides=(1, 1),
                    paddings=(0, 0), act=None, impl=None):
    """Fused NHWC conv + bias + residual + act, differentiable in x, w,
    bias and residual.  x [N,H,W,Cin]; w [O,Cin,KH,KW]; bias [O];
    residual [N,OH,OW,O]; act None or "relu"; ``impl`` as in the module
    docstring."""
    return ConvEpilogue.apply(x, w, bias, residual,
                              tuple(int(s) for s in strides),
                              _norm_padding(paddings), act or "", impl)


# ---------------------------------------------------------------------------
# conv + BN statistics, normalise, and the fused train chain
# ---------------------------------------------------------------------------

def conv2d_bn_stats(x, w, bias=None, *, strides=(1, 1), paddings=(0, 0),
                    impl=None):
    """NHWC conv (+ bias) with the per-channel batch statistics of its
    output: (y, mean, var), the statistics in f32."""
    strides = tuple(int(s) for s in strides)
    padding = _norm_padding(paddings)
    impl = _resolve(impl, x, "conv2d_bn_stats")
    if impl == "pallas":
        y, s1, s2 = conv_stats_kernel(x, w, bias, strides, padding)
    elif impl == "interpret":
        y, s1, s2 = conv_stats_plain(x, w, bias, strides, padding)
    else:
        y, s1, s2 = _conv_stats_xla(x, w, bias, strides, padding)
    mean, var = _finalize_stats(s1, s2, float(y.shape[0] * y.shape[1]
                                              * y.shape[2]))
    return y, mean, var


def bn_normalize_epilogue(y, mean, var, scale, shift, residual=None, *,
                          epsilon=1e-5, act=None, impl=None):
    """Normalise + scale/shift + residual + act in one pass over the NHWC
    y; mean/var/scale/shift are [C]."""
    impl = _resolve(impl, y, "bn_normalize_epilogue")
    rstd = torch.rsqrt(var.float() + epsilon)
    if impl == "pallas":
        return bn_apply_kernel(y, mean, rstd, scale, shift, residual,
                               act or "")
    return bn_apply_plain(y, mean, rstd, scale, shift, residual, act or "")


def _conv_bn_unfused(x, w, bias, scale, shift, residual, strides, padding,
                     act, eps):
    """The op sequence of the never-fused train graph, term for term
    (``paddle_tpu/ops/pallas_conv.py:608-630``): conv, ``_moments_1pass``
    batch statistics, normalise in f32 and cast, residual add, relu.
    Returns (out, mean, var, y)."""
    y = _conv_core(x, w, strides, padding)
    if bias is not None:
        y = y + bias.to(y.dtype)
    xf = y.to(scale.dtype)
    mean, var = _moments_1pass(xf, (0, 1, 2))
    t = (xf - mean) * torch.rsqrt(var + eps) * scale + shift
    t = t.to(y.dtype)
    if residual is not None:
        t = t + residual
    if act == "relu":
        t = torch.maximum(t, torch.zeros_like(t))
    return t, mean, var, y


def _conv_bn_core(x, w, bias, scale, shift, residual, strides, padding,
                  act, eps, impl):
    """(out, mean, var, y) of the fused chain: the two kernels (or their
    plain versions), or the unfused composite."""
    if impl in ("pallas", "interpret"):
        stats = conv_stats_kernel if impl == "pallas" else conv_stats_plain
        apply = bn_apply_kernel if impl == "pallas" else bn_apply_plain
        y, s1, s2 = stats(x, w, bias, strides, padding)
        mean, var = _finalize_stats(
            s1, s2, float(y.shape[0] * y.shape[1] * y.shape[2]))
        out = apply(y, mean, torch.rsqrt(var + eps), scale.float(),
                    shift.float(), residual, act)
        return out, mean, var, y
    return _conv_bn_unfused(x, w, bias, scale, shift, residual, strides,
                            padding, act, eps)


class ConvBnAct(torch.autograd.Function):
    """(out, batch mean, batch var) of conv + train-mode BN + residual +
    act.  The backward mirrors ``_conv_bn_act_bwd``
    (``paddle_tpu/ops/pallas_conv.py:670-714``): the closed-form BN
    backward on the saved statistics, with the cotangents of the mean
    and var outputs folded in (d mean/d y = 1/m, d var/d y =
    2 (y - mean)/m), and the relu masked by the saved output."""

    @staticmethod
    def forward(ctx, x, w, bias, scale, shift, residual, strides, padding,
                act, eps, impl):
        impl = _resolve(impl, x, "conv2d_bn_act")
        out, mean, var, y = _conv_bn_core(x, w, bias, scale, shift,
                                          residual, strides, padding, act,
                                          eps, impl)
        ctx.save_for_backward(x, w, bias, scale, residual, y, mean, var,
                              out)
        ctx.strides, ctx.padding, ctx.act, ctx.eps = (strides, padding,
                                                      act, eps)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, g_mean, g_var):
        x, w, bias, scale, residual, y, mean, var, out = ctx.saved_tensors
        if ctx.act == "relu":
            g = torch.where(out > 0, g, torch.zeros_like(g))
        dres = None if residual is None else g.to(residual.dtype)
        f32 = scale.dtype
        m = float(y.shape[0] * y.shape[1] * y.shape[2])
        axes = (0, 1, 2)
        yf = y.to(f32)
        dyf = g.to(f32)
        rstd = torch.rsqrt(var + ctx.eps)
        x_hat = (yf - mean) * rstd
        dshift = torch.sum(dyf, dim=axes)
        dscale = torch.sum(dyf * x_hat, dim=axes)
        dy = scale * rstd * (dyf - dshift / m - x_hat * (dscale / m))
        dy = dy + g_mean / m + (yf - mean) * (2.0 / m * g_var)
        dy = dy.to(y.dtype)
        ct = torch.promote_types(x.dtype, w.dtype)
        dx, dw = _conv_grads(dy.to(ct), x, w, ctx.strides, ctx.padding)
        db = None if bias is None else torch.sum(
            dy.float(), dim=axes).to(bias.dtype)
        return (dx, dw, db, dscale.to(scale.dtype), dshift.to(scale.dtype),
                dres, None, None, None, None, None)


def conv2d_bn_act(x, w, scale, shift, bias=None, residual=None, *,
                  strides=(1, 1), paddings=(0, 0), act=None, epsilon=1e-5,
                  impl=None):
    """Fused NHWC conv + train-mode BN + residual + act: (out,
    batch_mean, batch_var), differentiable in x, w, bias, scale, shift
    and residual.  scale/shift are BN's gamma/beta [O] (f32); ``impl``
    as in the module docstring."""
    return ConvBnAct.apply(x, w, bias, scale, shift, residual,
                           tuple(int(s) for s in strides),
                           _norm_padding(paddings), act or "",
                           float(epsilon), impl)


# ---------------------------------------------------------------------------
# the IR ops and their flags
# ---------------------------------------------------------------------------

def flag_impl(name):
    """The conv flag ``name`` as an impl: ``off`` (and any unknown value)
    runs the unfused composite, so a rewritten program under the flag's
    default computes what the original one does."""
    from paddle_tpu_torch.flags import get_flag

    mode = get_flag(name)
    if mode in ("pallas", "interpret", "xla"):
        return mode
    if mode == "on":
        return None
    return "xla"


def _to_nhwc(t):
    return None if t is None else t.permute(0, 2, 3, 1)


@register_op("conv2d_epilogue",
             inputs=("Input", "Filter", "Bias", "Residual"),
             outputs=("Output",),
             optional=("Bias", "Residual"),
             attrs={"strides": [1, 1], "paddings": [0, 0], "act": "",
                    "groups": 1, "data_format": "NCHW",
                    "epilogue": ""})
def _conv2d_epilogue_op(ins, attrs, device):
    """conv2d + channel bias + residual add + act as one op; an NCHW
    program is run in NHWC inside the op."""
    x, residual = ins["Input"], ins.get("Residual")
    nchw = attrs.get("data_format", "NCHW") == "NCHW"
    if nchw:
        x, residual = _to_nhwc(x), _to_nhwc(residual)
    out = conv2d_epilogue(x, ins["Filter"], ins.get("Bias"), residual,
                          strides=attrs["strides"],
                          paddings=attrs["paddings"],
                          act=attrs.get("act") or None,
                          impl=flag_impl("conv_epilogue"))
    return {"Output": out.permute(0, 3, 1, 2) if nchw else out}


@register_op("conv2d_bn_train",
             inputs=("Input", "Filter", "Bias", "Scale", "BNBias",
                     "Mean", "Variance", "Residual"),
             outputs=("Output", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             optional=("Bias", "Residual"),
             attrs={"strides": [1, 1], "paddings": [0, 0], "act": "",
                    "groups": 1, "epsilon": 1e-5, "momentum": 0.9,
                    "data_format": "NCHW", "epilogue": ""})
def _conv2d_bn_train_op(ins, attrs, device):
    """conv2d + train-mode batch_norm + residual add + act as one op, the
    target of ``transpiler.fuse_conv_bn_train``.  The outputs keep
    batch_norm's contract: MeanOut/VarianceOut are the updated running
    statistics (wired back onto the running-stat vars), SavedMean the
    batch mean, SavedVariance 1/sqrt(var + eps)."""
    x, residual = ins["Input"], ins.get("Residual")
    mean_in, var_in = ins["Mean"], ins["Variance"]
    eps, mom = attrs["epsilon"], attrs["momentum"]
    nchw = attrs.get("data_format", "NCHW") == "NCHW"
    if nchw:
        x, residual = _to_nhwc(x), _to_nhwc(residual)
    out, mean, var = conv2d_bn_act(
        x, ins["Filter"], ins["Scale"], ins["BNBias"], ins.get("Bias"),
        residual, strides=attrs["strides"], paddings=attrs["paddings"],
        act=attrs.get("act") or None, epsilon=eps,
        impl=flag_impl("conv_bn_stats"))
    if nchw:
        out = out.permute(0, 3, 1, 2)
    return {"Output": out,
            "MeanOut": mean_in * mom + mean.detach() * (1 - mom),
            "VarianceOut": var_in * mom + var.detach() * (1 - mom),
            "SavedMean": mean,
            "SavedVariance": 1.0 / torch.sqrt(var + eps)}
