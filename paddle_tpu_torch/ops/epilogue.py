"""The epilogue stage grammar and the fused matmul epilogue.

Counterpart of ``paddle_tpu/ops/epilogue.py``:

- The stage grammar (``EpilogueStage``, ``EpilogueSpec``, ``spec_attr``,
  ``enumerate_specs``, ``:87-265``): a fused op's ``epilogue`` attr is an
  ordered, validated ``"bias+residual+relu"``-style list of stages.
- The two evaluators (``:295-321``).  ``apply_acc_stages`` is the kernel
  order: bias, residual and act on the f32 accumulator, one cast after.
  ``apply_chain_stages`` is the unfused graph's order: each add in the
  tensor's dtype, the act last.  The chain's relu is ``maximum(y, 0)``,
  whose gradient at ``y == 0`` is 0.5, as ``jnp.maximum``'s is (the
  ``relu`` op's, ``torch.relu``, is 0).  ``apply_bn_tail`` is the
  normalize kernel's tail (``:324-333``).
- ``quantize_tail`` (``:336``), the requantize stage of the int8 ops, and
  ``greedy_logits_tail`` (``:346``), the argmax stage the decode engine
  samples with.
- ``fc_epilogue``: ``act(x @ w + bias + residual)`` on ``x [M,K]``,
  ``w [K,N]``, ``bias [N]``, ``residual [M,N]``, in ``promote(x, w)``.
  Its kernel replaces ``_fc_ep_kernel`` (wrapper ``_fc_ep_pallas``,
  ``:370,406``): ``csrc/fc_epilogue.cu``, whose header says how it is
  laid out and what bounds it.  It covers every shape: the Pallas
  wrapper's quiet fall-back to the chain above Mosaic's VMEM budget is a
  TPU rule and is gone.  ``fc_kernel_path`` picks the kernel's path from
  the shape and alignment (bf16 ``wgmma`` where TMA can address the
  operands, else ``mma_sync``; ``f32``); the entry point refuses a path
  the operands do not allow.  Launches are counted in
  ``fc_epilogue.launches`` and by path in
  ``fc_epilogue.launches_by_path``.
- ``FcEpilogue``, the ``torch.autograd.Function``: the forward runs the
  chosen implementation; the backward is autograd of the chain,
  recomputed from the saved inputs in their dtype, as ``_fc_ep_bwd``
  (``:469-495``) takes ``jax.vjp`` of it.
- The ``fc_epilogue`` IR op (``:557-582``), the target of
  ``transpiler.fuse_epilogue``, with ``mul``'s flattening.

Implementations (``impl``), chosen by the ``fc_epilogue`` flag for the
op (``_fc_impl_from_flag``):

  ``"xla"``        the chain, on any device (flags ``off`` and ``xla``)
  ``"interpret"``  the kernel's plain PyTorch version, on any device
  ``"pallas"``     the CUDA kernel; a CPU tensor raises
  ``None``         (flag ``on``) the kernel on a CUDA tensor, the chain
                   on a CPU one, as the JAX package's auto mode runs the
                   chain off the TPU

``meta`` tensors (shape inference) take the plain versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.observability import device_trace as _obs_device
from paddle_tpu_torch.observability import tracing as _obs_trace
from paddle_tpu_torch.ops.basic import gelu_fn

_KERNEL = "fc_epilogue"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# stage grammar
# ---------------------------------------------------------------------------

class EpilogueStage:
    """One stage: its canonical position, the operand slot it binds (if
    any), whether it is an activation (at most one a spec) and whether it
    must come last."""

    def __init__(self, name, order, operand=None, is_act=False,
                 terminal=False):
        self.name = name
        self.order = order
        self.operand = operand
        self.is_act = is_act
        self.terminal = terminal

    def __repr__(self):
        return f"EpilogueStage({self.name!r})"


# stages of one order never occur together (bn_apply and stats_tap share
# conv2d_bn_train's slot)
STAGES = {
    "bias": EpilogueStage("bias", 0, operand="Bias"),
    "stats_tap": EpilogueStage("stats_tap", 1),
    "bn_apply": EpilogueStage("bn_apply", 1),
    "residual": EpilogueStage("residual", 2, operand="Residual"),
    "relu": EpilogueStage("relu", 3, is_act=True),
    "gelu": EpilogueStage("gelu", 3, is_act=True),
    "requantize": EpilogueStage("requantize", 4, operand="OutScale"),
    "argmax": EpilogueStage("argmax", 5, terminal=True),
}

_SEP = "+"


class EpilogueSpec:
    """An ordered, validated list of stage names: the value of the
    ``epilogue`` op attr, serialised by ``to_attr``."""

    def __init__(self, stages=()):
        self.stages = tuple(stages)
        self.validate()

    @classmethod
    def from_attr(cls, attr):
        """Parses the attr string; the empty string is the empty spec."""
        if not attr:
            return cls(())
        return cls(tuple(attr.split(_SEP)))

    def to_attr(self):
        return _SEP.join(self.stages)

    def validate(self):
        """Raises ValueError unless every name is registered, the
        canonical order holds, no stage repeats, there is at most one
        activation and a terminal stage comes last."""
        last_order = -1
        seen = set()
        n_act = 0
        for i, name in enumerate(self.stages):
            st = STAGES.get(name)
            if st is None:
                raise ValueError(
                    f"epilogue spec {self.stages!r}: unknown stage "
                    f"{name!r} (registered: {sorted(STAGES)})")
            if name in seen:
                raise ValueError(
                    f"epilogue spec {self.stages!r}: duplicate stage "
                    f"{name!r}")
            seen.add(name)
            if st.order < last_order:
                raise ValueError(
                    f"epilogue spec {self.stages!r}: stage {name!r} "
                    "out of canonical order (bias -> stats_tap/"
                    "bn_apply -> residual -> act -> requantize -> "
                    "argmax)")
            last_order = st.order
            if st.is_act:
                n_act += 1
                if n_act > 1:
                    raise ValueError(
                        f"epilogue spec {self.stages!r}: more than "
                        "one activation stage")
            if st.terminal and i != len(self.stages) - 1:
                raise ValueError(
                    f"epilogue spec {self.stages!r}: terminal stage "
                    f"{name!r} must come last")
        return self

    def __contains__(self, name):
        return name in self.stages

    def __iter__(self):
        return iter(self.stages)

    def __len__(self):
        return len(self.stages)

    def __eq__(self, other):
        return isinstance(other, EpilogueSpec) and \
            self.stages == other.stages

    def __hash__(self):
        return hash(self.stages)

    def __repr__(self):
        return f"EpilogueSpec({self.to_attr()!r})"

    @property
    def act(self):
        """The activation stage name, or '' when none."""
        for name in self.stages:
            if STAGES[name].is_act:
                return name
        return ""


def spec_attr(*, bias=False, stats_tap=False, bn_apply=False,
              residual=False, act="", requantize=False, argmax=False):
    """The canonical attr string of a fused op's stages: the one way a
    transpiler stamps the ``epilogue`` attr, valid by construction."""
    stages = []
    if bias:
        stages.append("bias")
    if stats_tap:
        stages.append("stats_tap")
    if bn_apply:
        stages.append("bn_apply")
    if residual:
        stages.append("residual")
    if act:
        if act not in STAGES or not STAGES[act].is_act:
            raise ValueError(f"unknown activation stage {act!r}")
        stages.append(act)
    if requantize:
        stages.append("requantize")
    if argmax:
        stages.append("argmax")
    return EpilogueSpec(stages).to_attr()


def enumerate_specs(anchor):
    """Every legal spec an anchor can carry: 'conv' (conv2d_epilogue),
    'conv_bn' (conv2d_bn_train), 'fc' (fc_epilogue) or 'int8'."""
    if anchor == "conv":
        choices = (("", "bias"), ("", "residual"), ("", "relu"))
    elif anchor == "conv_bn":
        choices = (("", "bias"), ("stats_tap",), ("bn_apply",),
                   ("", "residual"), ("", "relu"))
    elif anchor == "fc":
        choices = (("", "bias"), ("", "residual"),
                   ("", "relu", "gelu"))
    elif anchor == "int8":
        choices = (("", "bias"), ("", "residual"), ("", "relu"),
                   ("", "requantize"))
    else:
        raise ValueError(f"unknown epilogue anchor {anchor!r}")

    def _prod(choice_lists):
        if not choice_lists:
            yield ()
            return
        for rest in _prod(choice_lists[1:]):
            for c in choice_lists[0]:
                yield ((c,) if c else ()) + rest

    for stages in _prod(list(choices)):
        yield EpilogueSpec(stages)


# ---------------------------------------------------------------------------
# the two evaluators
# ---------------------------------------------------------------------------

def _act_fn(act, approximate=False):
    """relu is ``maximum(y, 0)`` (gradient 0.5 at a tie, as jnp.maximum;
    ``clamp_min`` would give 1 and ``torch.relu`` 0); gelu is the gelu
    op's formula."""
    if not act:
        return lambda y: y
    if act == "relu":
        return lambda y: torch.maximum(y, torch.zeros_like(y))
    if act == "gelu":
        return lambda y: gelu_fn(y, approximate)
    raise ValueError(f"unknown activation stage {act!r}")


def apply_acc_stages(acc, *, bias=None, residual=None, act="",
                     approximate=False):
    """Kernel order: bias, residual and act on the f32 accumulator; the
    caller casts to the output dtype afterwards."""
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    return _act_fn(act, approximate)(acc)


def apply_chain_stages(y, *, bias=None, residual=None, act="",
                       approximate=False):
    """Chain order: the ops the unfused graph runs, each add in y's
    dtype, the act last."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return _act_fn(act, approximate)(y)


def apply_bn_tail(t, out_dtype, residual=None, act=""):
    """The BN-apply tail (``paddle_tpu/ops/epilogue.py:324-333``): cast
    the f32 normalised value to the conv's dtype first, then the
    residual add in that dtype, then the act, which are the unfused
    batch_norm -> elementwise_add -> relu chain's rounding points."""
    t = t.to(out_dtype)
    if residual is not None:
        t = t + residual.to(out_dtype)
    return _act_fn(act)(t)


def quantize_tail(y, out_scale, bnd):
    """The requantize stage (``paddle_tpu/ops/epilogue.py:336``): the
    epilogue's result quantised to the consumer's calibrated scale
    (symmetric, zero point 0), ``clip(round(y / so * bnd), -bnd, bnd)``
    as int8 with ``so = max(out_scale, 1e-8)``, all in f32 and rounding
    half to even: the int8 boundary's rounding point, shared by
    conv2d_int8, mul_int8 and requantize."""
    so = torch.clamp_min(out_scale.reshape(()).float(), 1e-8)
    return torch.clamp(torch.round(y.float() / so * bnd), -bnd,
                       bnd).to(torch.int8)


def greedy_logits_tail(logits, axis=-1):
    """The argmax stage (``paddle_tpu/ops/epilogue.py:346``): the decode
    engine's greedy sampling tail over the model's logits, for its
    step, draft and verify sweeps.  The first maximum wins, as
    ``jnp.argmax``'s does."""
    return torch.argmax(logits, dim=axis)


# ---------------------------------------------------------------------------
# fc_epilogue: the kernel, its plain versions, the autograd Function
# ---------------------------------------------------------------------------

def _fc_reference(x2, w2, bias, residual, act, approximate):
    """The unfused chain: the product in the input dtype, then
    ``apply_chain_stages`` (what flags ``off`` and ``xla`` run)."""
    ct = torch.promote_types(x2.dtype, w2.dtype)
    return apply_chain_stages(torch.matmul(x2.to(ct), w2.to(ct)),
                              bias=bias, residual=residual, act=act,
                              approximate=approximate)


def fc_epilogue_plain(x2, w2, bias, residual, act, approximate):
    """The kernel's function in plain PyTorch: the product of the
    operands upcast to f32 (a bf16 ``matmul`` on the CPU would round its
    result to bf16 before the epilogue), the epilogue on that f32
    accumulator, one cast to ``promote(x, w)``."""
    acc = torch.matmul(x2.float(), w2.float())
    acc = apply_acc_stages(acc, bias=bias, residual=residual, act=act,
                           approximate=approximate)
    return acc.to(torch.promote_types(x2.dtype, w2.dtype))


def _act_code(act, approximate):
    if not act:
        return 0
    if act == "relu":
        return 1
    if act == "gelu":
        return 3 if approximate else 2
    raise ValueError(f"unknown activation stage {act!r}")


def _check(x2, w2, bias, residual):
    if x2.dim() != 2 or w2.dim() != 2 or x2.shape[1] != w2.shape[0]:
        raise ValueError(f"fc_epilogue: x {tuple(x2.shape)} and w "
                         f"{tuple(w2.shape)} are not [M,K] and [K,N]")
    m, n = x2.shape[0], w2.shape[1]
    if x2.dtype not in _DTYPE_CODES or w2.dtype != x2.dtype:
        raise TypeError("fc_epilogue: x and w must both be float32 or both "
                        f"bfloat16, got {x2.dtype}/{w2.dtype}")
    for name, t, shape in (("bias", bias, (n,)), ("residual", residual,
                                                  (m, n))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"fc_epilogue: {name} {tuple(t.shape)} is "
                             f"not {shape}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"fc_epilogue: {name} must be float32 or "
                            f"bfloat16, got {t.dtype}")
    tensors = [t for t in (x2, w2, bias, residual) if t is not None]
    if any(t.device != x2.device for t in tensors):
        raise ValueError("fc_epilogue: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fc_epilogue: the kernel takes contiguous "
                         "row-major operands")


FC_PATHS = ("f32", "mma_sync", "wgmma")   # the entry point's path codes


def fc_kernel_path(k, n, dtype, aligned):
    """The kernel path of an fc_epilogue call with x [M,K] and w [K,N]
    (contiguous) of ``dtype``: ``"f32"`` (CUDA cores) for float32; for
    bfloat16 ``"wgmma"`` (TMA ring, wgmma) where TMA can address both
    operands' rows (K > 0, K and N multiples of 8, so rows of whole
    16-byte chunks, and ``aligned``: x and w start on 16 bytes), else
    ``"mma_sync"``.  M does not enter: every path takes any M."""
    if dtype == torch.float32:
        return "f32"
    if k > 0 and k % 8 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def _launch(x2, w2, bias, residual, act, approximate):
    # the Pallas kernel casts both operands to promote(x, w) as well
    ct = torch.promote_types(x2.dtype, w2.dtype)
    x2, w2 = x2.to(ct), w2.to(ct)
    _check(x2, w2, bias, residual)
    (m, k), n = x2.shape, w2.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    if out.numel() == 0:
        return out
    path = fc_kernel_path(k, n, x2.dtype, x2.data_ptr() % 16 == 0
                          and w2.data_ptr() % 16 == 0)
    lib = _load()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.pt_fc_epilogue(
            x2.data_ptr(), w2.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), m, n, k, _DTYPE_CODES[x2.dtype],
            -1 if bias is None else _DTYPE_CODES[bias.dtype],
            -1 if residual is None else _DTYPE_CODES[residual.dtype],
            _act_code(act, approximate), FC_PATHS.index(path), stream)
    if err != 0:
        raise RuntimeError(f"fc_epilogue kernel launch ({path}) failed: "
                           + lib.pt_cuda_error_string(err).decode())
    fc_epilogue.launches += 1
    fc_epilogue.launches_by_path[path] += 1
    return out


def _load():
    """Builds (at first use) and loads the kernel's library."""
    from paddle_tpu_torch import _build

    lib = _build.load(_KERNEL)
    if lib.pt_fc_epilogue.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pt_fc_epilogue.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        lib.pt_fc_epilogue.restype = i32
        lib.pt_cuda_error_string.argtypes = [i32]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fc_epilogue_kernel(x2, w2, bias=None, residual=None, act="",
                       approximate=False):
    """The kernel's wrapper: a CUDA tensor launches ``csrc/fc_epilogue.cu``
    (a build or launch failure raises), a CPU or meta tensor takes
    ``fc_epilogue_plain``."""
    if x2.device.type == "cuda":
        return _launch(x2, w2, bias, residual, act, approximate)
    if x2.device.type in ("cpu", "meta"):
        return fc_epilogue_plain(x2, w2, bias, residual, act, approximate)
    raise ValueError(f"fc_epilogue: no implementation for device "
                     f"{x2.device}")


def _forward(x2, w2, bias, residual, act, approximate, impl):
    if impl == "xla":
        return _fc_reference(x2, w2, bias, residual, act, approximate)
    if impl == "interpret":
        return fc_epilogue_plain(x2, w2, bias, residual, act, approximate)
    if impl == "pallas":
        if x2.device.type == "cpu":
            raise ValueError("fc_epilogue: impl 'pallas' runs the CUDA "
                             "kernel and was given a CPU tensor; use "
                             "'interpret' or 'xla' on the CPU")
        return fc_epilogue_kernel(x2, w2, bias, residual, act, approximate)
    if impl is None:
        if x2.device.type == "cuda":
            return _launch(x2, w2, bias, residual, act, approximate)
        return _fc_reference(x2, w2, bias, residual, act, approximate)
    raise ValueError(f"fc_epilogue: unknown impl {impl!r}")


class FcEpilogue(torch.autograd.Function):
    """``act(x @ w + bias + residual)``; the backward is autograd of the
    chain, recomputed from the saved inputs in their dtype."""

    @staticmethod
    def forward(ctx, x2, w2, bias, residual, act, approximate, impl):
        ctx.save_for_backward(x2, w2, bias, residual)
        ctx.act, ctx.approximate = act, approximate
        return _forward(x2, w2, bias, residual, act, approximate, impl)

    @staticmethod
    def backward(ctx, g):
        x2, w2, bias, residual = ctx.saved_tensors
        args = [t for t in (x2, w2, bias, residual) if t is not None]
        leaves = [t.detach().requires_grad_() for t in args]
        it = iter(leaves)
        x_l, w_l = next(it), next(it)
        b_l = next(it) if bias is not None else None
        r_l = next(it) if residual is not None else None
        with torch.enable_grad():
            y = _fc_reference(x_l, w_l, b_l, r_l, ctx.act, ctx.approximate)
            grads = iter(torch.autograd.grad(y, leaves, g))
        dx, dw = next(grads), next(grads)
        db = next(grads) if bias is not None else None
        dr = next(grads) if residual is not None else None
        return dx, dw, db, dr, None, None, None


def fc_epilogue(x, w, bias=None, residual=None, *, act=None,
                approximate=False, impl=None):
    """Fused ``act(x @ w + bias + residual)``, differentiable in every
    operand.  x [M,K], w [K,N], bias [N], residual [M,N]; act None,
    "relu" or "gelu" (``approximate`` as the gelu op's); ``impl`` as in
    the module docstring.  With tracing on, the entry is a device-trace
    annotation site."""
    args = (x, w, bias, residual, act or "", bool(approximate), impl)
    if _obs_trace._tracer is not None:
        with _obs_device.annotate("fc_epilogue"):
            return FcEpilogue.apply(*args)
    return FcEpilogue.apply(*args)


fc_epilogue.launches = 0
fc_epilogue.launches_by_path = dict.fromkeys(FC_PATHS, 0)


def _fc_impl_from_flag():
    """The ``fc_epilogue`` flag as an impl: ``off`` (and any unknown
    value) runs the chain, so a fused program under the flag's default
    computes what the unfused one does."""
    from paddle_tpu_torch.flags import get_flag

    mode = get_flag("fc_epilogue")
    if mode in ("pallas", "interpret", "xla"):
        return mode
    if mode == "on":
        return None
    return "xla"


@register_op("fc_epilogue",
             inputs=("X", "Y", "Bias", "Residual"),
             outputs=("Out",),
             optional=("Bias", "Residual"),
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1,
                    "act": "", "approximate": False, "epilogue": ""})
def _fc_epilogue_op(ins, attrs, device):
    """mul + bias + residual + act as one op.  X and Y are flattened as
    the mul op does; Residual is read in the output's shape and flattened
    beside it."""
    x, w = ins["X"], ins["Y"]
    bias = ins.get("Bias")
    residual = ins.get("Residual")
    xnc, ync = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    x2 = x.reshape(int(np.prod(x.shape[:xnc])), -1).contiguous()
    w2 = w.reshape(int(np.prod(w.shape[:ync])), -1).contiguous()
    out_shape = tuple(x.shape[:xnc]) + tuple(w.shape[ync:])
    if residual is not None:
        residual = residual.reshape(x2.shape[0], w2.shape[1]).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    out = fc_epilogue(x2, w2, bias, residual, act=attrs["act"] or None,
                      approximate=attrs["approximate"],
                      impl=_fc_impl_from_flag())
    return {"Out": out.reshape(out_shape)}
