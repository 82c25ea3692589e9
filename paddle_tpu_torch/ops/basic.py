"""Elementwise, math and tensor-manipulation ops on torch tensors.

Counterpart of ``paddle_tpu/ops/basic.py``: the same op types, slots,
attrs and defaults.  Every compute also runs on ``meta`` tensors, which
is how ``Block.append_op`` infers shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import REQUIRED, register_op
from paddle_tpu_torch.core.types import to_torch_dtype


def _bcast_y(x, y, axis):
    """Fluid elementwise broadcast: Y's dims align to X's dims starting at
    ``axis`` (default -1 = trailing-aligned)."""
    if y.ndim == x.ndim or y.ndim == 0 or y.ndim > x.ndim:
        return y
    a = x.ndim - y.ndim if axis == -1 else axis
    trailing = x.ndim - a - y.ndim
    if trailing > 0:
        y = y.reshape(tuple(y.shape) + (1,) * trailing)
    return y


def _np_rng(seed):
    if seed:
        return np.random.RandomState(seed)
    return np.random


def _host_array(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# ---------------------------------------------------------------------------
# fill / random init ops.  They draw on the host with numpy exactly as the
# JAX package's ops do, so the same np.random.seed gives the same
# parameters in both packages.  The draw happens on the meta device too:
# the JAX package's shape inference runs the compute (jax.eval_shape) and
# so consumes numpy's global generator at build time as well.
# ---------------------------------------------------------------------------

@register_op("fill_constant", inputs=(), outputs=("Out",),
             attrs={"shape": REQUIRED, "dtype": "float32", "value": 0.0},
             differentiable=False)
def fill_constant(ins, attrs, device):
    return {"Out": torch.full(tuple(attrs["shape"]), attrs["value"],
                              dtype=to_torch_dtype(attrs["dtype"]),
                              device=device)}


@register_op("uniform_random", inputs=(), outputs=("Out",),
             attrs={"shape": REQUIRED, "min": -1.0, "max": 1.0, "seed": 0,
                    "dtype": "float32"},
             differentiable=False)
def uniform_random(ins, attrs, device):
    rng = _np_rng(attrs["seed"])
    x = rng.uniform(attrs["min"], attrs["max"], size=tuple(attrs["shape"]))
    return {"Out": _host_array(x.astype(attrs["dtype"]), device)}


@register_op("assign_value", inputs=(), outputs=("Out",),
             attrs={"values": REQUIRED, "dtype": None},
             differentiable=False)
def assign_value(ins, attrs, device):
    arr = np.asarray(attrs["values"])
    if attrs["dtype"]:
        arr = arr.astype(attrs["dtype"])
    return {"Out": _host_array(arr, device)}


@register_op("assign", inputs=("X",), outputs=("Out",))
def assign(ins, attrs, device):
    return {"Out": ins["X"]}


@register_op("fill_zeros_like", inputs=("X",), outputs=("Out",),
             differentiable=False)
def fill_zeros_like(ins, attrs, device):
    return {"Out": torch.zeros_like(ins["X"])}


@register_op("cast", inputs=("X",), outputs=("Out",),
             attrs={"out_dtype": REQUIRED})
def cast(ins, attrs, device):
    return {"Out": ins["X"].to(to_torch_dtype(attrs["out_dtype"]))}


@register_op("sum", inputs=("X",), outputs=("Out",), duplicable=("X",))
def sum_op(ins, attrs, device):
    """Var-arity add, in order; the backward's gradient accumulation."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("scale", inputs=("X",), outputs=("Out",),
             attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True})
def scale(ins, attrs, device):
    x = ins["X"]
    if attrs["bias_after_scale"]:
        return {"Out": x * attrs["scale"] + attrs["bias"]}
    return {"Out": (x + attrs["bias"]) * attrs["scale"]}


def _operands(ins, axis):
    """X and Y of a binary op in their common dtype, Y broadcast.  Both
    are cast to ``promote_types`` first, as jnp promotes arrays: torch
    would keep a bf16 X's dtype against a 0-d f32 Y."""
    x, y = ins["X"], ins["Y"]
    dt = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dt), y.to(dt)
    return x, _bcast_y(x, y, axis)


def _k(x, value):
    """``value`` as a 0-d tensor of x's dtype on x's device.  jnp casts a
    Python float to the array's dtype before it computes (a weak type),
    where torch would multiply a bf16 tensor by the float's f32 value:
    every Python constant of the family's formulas goes through here."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# the elementwise binary family (``paddle_tpu/ops/basic.py:172-191``)
# ---------------------------------------------------------------------------

def _mod(x, y):
    """``jnp.mod``: C's remainder moved to the divisor's sign; an integer
    divisor 0 counts as 1."""
    if not y.is_floating_point():
        y = torch.where(y == 0, torch.ones_like(y), y)
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _floordiv(x, y):
    """``jnp.floor_divide``: integers by truncation, one less where the
    signs differ and the remainder is not 0; floats as CPython's
    float_divmod, the quotient rounded half away from 0 (``lax.round``)."""
    if not x.is_floating_point():
        q = torch.div(x, y, rounding_mode="trunc")
        fix = (torch.sign(x) != torch.sign(y)) & (torch.fmod(x, y) != 0)
        return torch.where(fix, q - 1, q)
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    fix = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    div = torch.where(fix, div - _k(div, 1.0), div)
    t = torch.trunc(div)
    return torch.where((div - t).abs() == 0.5, t + torch.sign(div),
                       torch.round(div))


def _register_elementwise(name, fn, differentiable=True):
    @register_op(name, inputs=("X", "Y"), outputs=("Out",),
                 attrs={"axis": -1}, differentiable=differentiable)
    def _op(ins, attrs, device, fn=fn):
        return {"Out": fn(*_operands(ins, attrs["axis"]))}
    return _op


_register_elementwise("elementwise_add", torch.add)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_pow", torch.pow)
_register_elementwise("elementwise_mod", _mod, differentiable=False)
_register_elementwise("elementwise_floordiv", _floordiv,
                      differentiable=False)


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ins, attrs, device):
    return {"Out": torch.mean(ins["X"])}


# ---------------------------------------------------------------------------
# matmul / mul
# ---------------------------------------------------------------------------

@register_op("matmul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"transpose_X": False, "transpose_Y": False,
                    "alpha": 1.0})
def matmul(ins, attrs, device):
    """The transposes (of a 2-D or batched operand), the product, then
    ``alpha``.  A PyTorch product: the JAX package computes it in XLA,
    outside any Pallas kernel."""
    x, y = ins["X"], ins["Y"]
    dt = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dt), y.to(dt)
    if attrs["transpose_X"] and x.ndim > 1:
        x = x.transpose(-1, -2)
    if attrs["transpose_Y"] and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if attrs["alpha"] != 1.0:
        out = out * _k(out, attrs["alpha"])
    return {"Out": out}


@register_op("mul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
def mul(ins, attrs, device):
    """Flattens X to 2-D at x_num_col_dims and Y at y_num_col_dims, then
    one matrix product; the output keeps the unflattened dims."""
    x, y = ins["X"], ins["Y"]
    xnc, ync = attrs["x_num_col_dims"], attrs["y_num_col_dims"]
    x2 = x.reshape(int(np.prod(x.shape[:xnc])), -1)
    y2 = y.reshape(int(np.prod(y.shape[:ync])), -1)
    out = torch.matmul(x2, y2)
    return {"Out": out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))}


# ---------------------------------------------------------------------------
# the reduce family (``paddle_tpu/ops/basic.py:249-269``)
# ---------------------------------------------------------------------------

def _reduce_dims(attrs, ndim):
    """An empty ``dim`` or ``reduce_all`` reduces every dim."""
    if attrs.get("reduce_all") or not attrs.get("dim"):
        return tuple(range(ndim))
    return tuple(d % ndim for d in attrs["dim"])


def _prod(x, dim, keepdim):
    """``torch.prod`` takes one dim: the dims one at a time, last first."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim, dtype=x.dtype)
    return x


def _mean(x, dim, keepdim):
    return torch.mean(x if x.is_floating_point() else x.float(), dim=dim,
                      keepdim=keepdim)


def _register_reduce(name, fn, differentiable=True):
    @register_op(name, inputs=("X",), outputs=("Out",),
                 attrs={"dim": [0], "keep_dim": False, "reduce_all": False},
                 differentiable=differentiable)
    def _op(ins, attrs, device, fn=fn):
        x = ins["X"]
        dims = _reduce_dims(attrs, x.ndim)
        if not dims:
            return {"Out": fn(x.unsqueeze(0), (0,), False)}
        return {"Out": fn(x, dims, attrs["keep_dim"])}
    return _op


_register_reduce("reduce_sum", lambda x, d, k: torch.sum(x, dim=d,
                                                         keepdim=k))
_register_reduce("reduce_mean", _mean)
_register_reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d,
                                                          keepdim=k))
_register_reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d,
                                                          keepdim=k))
_register_reduce("reduce_prod", _prod)
_register_reduce("reduce_all", lambda x, d, k: torch.all(x, dim=d,
                                                         keepdim=k),
                 differentiable=False)
_register_reduce("reduce_any", lambda x, d, k: torch.any(x, dim=d,
                                                         keepdim=k),
                 differentiable=False)


# ---------------------------------------------------------------------------
# activations (``paddle_tpu/ops/basic.py:277-338``).  Each formula is the
# jax function's, step by step, so a bf16 input rounds where XLA rounds
# and a tie takes the same gradient: ``jnp.clip`` is a maximum, then a
# minimum (half the gradient to each side of a tie), ``jnp.where`` keeps
# its branch's gradient, ``jnp.abs`` has gradient 1 at 0, ``softplus`` is
# ``logaddexp(x, 0)``.
# ---------------------------------------------------------------------------

def _abs(x):
    """``jnp.abs``, whose gradient at 0 is 1 (``x >= 0`` takes g); the
    ``+ 0`` makes a -0.0 input +0.0, as ``jnp.abs`` returns it."""
    return torch.where(x >= 0, x + _k(x, 0.0), -x)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, _k(x, lo)), _k(x, hi))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _elu(x, alpha):
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, _k(x, alpha) * torch.expm1(safe))


def _softshrink(x, lam):
    return torch.where(x > _k(x, lam), x - _k(x, lam),
                       torch.where(x < _k(x, -lam), x + _k(x, lam),
                                   torch.zeros_like(x)))


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _register_act(name, fn, differentiable=True, extra_attrs=None):
    @register_op(name, inputs=("X",), outputs=("Out",),
                 attrs=dict(extra_attrs or {}),
                 differentiable=differentiable)
    def _op(ins, attrs, device, fn=fn):
        return {"Out": fn(ins["X"], attrs)}
    return _op


@register_op("relu", inputs=("X",), outputs=("Out",))
def relu(ins, attrs, device):
    return {"Out": torch.relu(ins["X"])}


def gelu_fn(x, approximate=False):
    """``jax.nn.gelu``'s formulas, constants in x's dtype: the exact form
    ``x/2 * erfc(-x/sqrt(2))``, or the tanh approximation."""
    if approximate:
        c = torch.full((), float(np.sqrt(2 / np.pi)), dtype=x.dtype,
                       device=x.device)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    c = torch.full((), float(np.sqrt(0.5)), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.special.erfc(-x * c)


@register_op("gelu", inputs=("X",), outputs=("Out",),
             attrs={"approximate": False})
def gelu(ins, attrs, device):
    return {"Out": gelu_fn(ins["X"], attrs["approximate"])}


_register_act("relu6", lambda x, a: _clip(x, 0.0, a["threshold"]),
              extra_attrs={"threshold": 6.0})
_register_act("leaky_relu",
              lambda x, a: torch.where(x >= 0, x, _k(x, a["alpha"]) * x),
              extra_attrs={"alpha": 0.02})
_register_act("sigmoid", lambda x, a: torch.sigmoid(x))
_register_act("logsigmoid", lambda x, a: -_softplus(-x))
_register_act("tanh", lambda x, a: torch.tanh(x))
_register_act("exp", lambda x, a: torch.exp(x))
_register_act("log", lambda x, a: torch.log(x))
_register_act("sqrt", lambda x, a: torch.sqrt(x))
_register_act("rsqrt", lambda x, a: torch.rsqrt(x))
_register_act("abs", lambda x, a: _abs(x))
_register_act("square", lambda x, a: torch.square(x))
_register_act("reciprocal", lambda x, a: torch.reciprocal(x))
_register_act("softplus", lambda x, a: _softplus(x))
_register_act("softsign", lambda x, a: x / (_abs(x) + _k(x, 1.0)))
_register_act("elu", lambda x, a: _elu(x, a["alpha"]),
              extra_attrs={"alpha": 1.0})
_register_act("selu",
              lambda x, a: _k(x, _SELU_SCALE) * _elu(x, _SELU_ALPHA))
_register_act("swish",
              lambda x, a: x * torch.sigmoid(_k(x, a["beta"]) * x),
              extra_attrs={"beta": 1.0})
_register_act("hard_sigmoid",
              lambda x, a: _clip(_k(x, a["slope"]) * x + _k(x, a["offset"]),
                                 0.0, 1.0),
              extra_attrs={"slope": 0.2, "offset": 0.5})
_register_act("hard_swish",
              lambda x, a: x * _clip(x + _k(x, a["offset"]), 0.0,
                                     a["threshold"]) / _k(x, a["scale"]),
              extra_attrs={"threshold": 6.0, "scale": 6.0, "offset": 3.0})
_register_act("floor", lambda x, a: torch.floor(x), differentiable=False)
_register_act("ceil", lambda x, a: torch.ceil(x), differentiable=False)
_register_act("round", lambda x, a: torch.round(x), differentiable=False)
_register_act("sin", lambda x, a: torch.sin(x))
_register_act("cos", lambda x, a: torch.cos(x))
_register_act("erf", lambda x, a: torch.special.erf(x))
_register_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_register_act("softshrink", lambda x, a: _softshrink(x, a["lambda"]),
              extra_attrs={"lambda": 0.5})
_register_act("hard_shrink",
              lambda x, a: torch.where(torch.abs(x) > _k(x, a["threshold"]),
                                       x, torch.zeros_like(x)),
              extra_attrs={"threshold": 0.5})
_register_act("thresholded_relu",
              lambda x, a: torch.where(x > _k(x, a["threshold"]), x,
                                       torch.zeros_like(x)),
              extra_attrs={"threshold": 1.0})
_register_act("stanh",
              lambda x, a: _k(x, a["scale_b"])
              * torch.tanh(_k(x, a["scale_a"]) * x),
              extra_attrs={"scale_a": 0.67, "scale_b": 1.7159})


@register_op("pow", inputs=("X",), outputs=("Out",),
             attrs={"factor": 1.0})
def pow_op(ins, attrs, device):
    """``jnp.power(x, factor)``: an int factor is an integer power, a
    float one a power by the factor in x's dtype."""
    x, factor = ins["X"], attrs["factor"]
    if isinstance(factor, int) and not isinstance(factor, bool):
        return {"Out": torch.pow(x, factor)}
    return {"Out": torch.pow(x, _k(x, float(factor)))}


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"),
             attrs={"soft_label": False, "ignore_index": -100, "axis": -1,
                    "numeric_stable_mode": True})
def softmax_with_cross_entropy(ins, attrs, device):
    logits, label = ins["Logits"], ins["Label"]
    axis = attrs["axis"]
    logp = torch.log_softmax(logits, dim=axis)
    if attrs["soft_label"]:
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lab = label
        if lab.ndim == logits.ndim and lab.shape[axis] == 1:
            lab = lab.squeeze(axis)
        lab = lab.unsqueeze(-1).long()
        loss = -torch.take_along_dim(logp, lab, dim=axis)
        if attrs["ignore_index"] >= 0:
            loss = torch.where(lab != attrs["ignore_index"], loss, 0.0)
    return {"Softmax": torch.exp(logp), "Loss": loss}


@register_op("sigmoid_cross_entropy_with_logits",
             inputs=("X", "Label"), outputs=("Out",),
             attrs={"ignore_index": -100, "normalize": False})
def sigmoid_cross_entropy_with_logits(ins, attrs, device):
    """``max(x, 0) - x*label + log1p(exp(-|x|))``; labels equal to
    ``ignore_index`` (when it is >= 0) give 0, and ``normalize`` divides
    by the count of the others (at least 1)."""
    x, label = ins["X"], ins["Label"]
    loss = torch.maximum(x, _k(x, 0.0)) - x * label \
        + torch.log1p(torch.exp(-_abs(x)))
    if attrs["ignore_index"] >= 0:
        mask = (label != attrs["ignore_index"]).to(x.dtype)
        loss = loss * mask
        if attrs["normalize"]:
            loss = loss / torch.maximum(torch.sum(mask), _k(mask, 1.0))
    return {"Out": loss}


@register_op("lookup_table", inputs=("W", "Ids"), outputs=("Out",),
             attrs={"padding_idx": -1, "is_sparse": False,
                    "is_distributed": False})
def lookup_table(ins, attrs, device):
    """Ids [..., 1] int64 -> Out [..., D]; padding_idx rows are zero.

    Like the JAX package's gather, a negative id counts from the end and
    an id out of range gives a NaN row: it never reaches the device as an
    out-of-bounds index, which on CUDA would be a device-side assert."""
    w, ids = ins["W"], ins["Ids"]
    idx = ids[..., 0] if ids.ndim >= 2 and ids.shape[-1] == 1 else ids
    idx = idx.long()
    valid = (idx >= -w.shape[0]) & (idx < w.shape[0])
    out = w[torch.where(valid, idx, 0)]
    out = torch.where(valid.unsqueeze(-1), out, float("nan"))
    if attrs["padding_idx"] >= 0:
        out = torch.where((idx != attrs["padding_idx"]).unsqueeze(-1),
                          out, 0.0)
    return {"Out": out}


def _xshape(x):
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


@register_op("reshape2", inputs=("X",), outputs=("Out", "XShape"),
             attrs={"shape": REQUIRED})
def reshape2(ins, attrs, device):
    x = ins["X"]
    shape = [x.shape[i] if d == 0 else d
             for i, d in enumerate(attrs["shape"])]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op("transpose2", inputs=("X",), outputs=("Out", "XShape"),
             attrs={"axis": REQUIRED})
def transpose2(ins, attrs, device):
    """Returns a permuted view: consumers that need contiguous memory
    (``mul``'s reshape) copy, and the flash kernel reads strided q/k/v."""
    x = ins["X"]
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("transpose", inputs=("X",), outputs=("Out",),
             attrs={"axis": REQUIRED})
def transpose(ins, attrs, device):
    """The layout pass's transpose (``paddle_tpu/ops/misc.py:117``), made
    contiguous: the NHWC conv stack behind it reads dense channels-last
    memory."""
    return {"Out": ins["X"].permute(*[int(a) for a in attrs["axis"]])
            .contiguous()}


@register_op("softmax", inputs=("X",), outputs=("Out",), attrs={"axis": -1})
def softmax(ins, attrs, device):
    return {"Out": torch.softmax(ins["X"], dim=attrs["axis"])}


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"),
             attrs={"k": 1}, differentiable=False)
def top_k(ins, attrs, device):
    """The k largest along the last axis, largest first.  A stable sort
    puts the lower index first among equal values, as ``lax.top_k``
    does (``torch.topk`` promises no order between ties)."""
    vals, idx = torch.sort(ins["X"], dim=-1, descending=True, stable=True)
    k = attrs["k"]
    return {"Out": vals[..., :k], "Indices": idx[..., :k]}


@register_op("dropout", inputs=("X", "SeedOffset"),
             outputs=("Out", "Mask"),
             optional=("SeedOffset",),
             attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0,
                    "dropout_implementation": "downgrade_in_infer"})
def dropout(ins, attrs, device):
    """Inference dropout (``paddle_tpu/ops/basic.py:793-817``), bit for
    bit: ``downgrade_in_infer`` scales by ``1 - p``, ``upscale_in_train``
    passes x through; Mask is ones.  jnp rounds the Python float ``1 -
    p`` to x's dtype before the product (a weak type), where torch would
    multiply a bf16 x by its f32 value: the factor is made a 0-d tensor
    of x's dtype.  Training with p > 0 draws threefry bits the port cannot
    match, and raises (ROADMAP Queue 1 item 6); at p == 0 every element
    is kept, so Out is x."""
    x = ins["X"]
    p = attrs["dropout_prob"]
    if attrs["is_test"]:
        upscale = attrs["dropout_implementation"] == "upscale_in_train"
        keep = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
        return {"Out": x if upscale else x * keep,
                "Mask": torch.ones_like(x)}
    if p > 0:
        raise NotImplementedError(
            "dropout: training mode (is_test=False, dropout_prob > 0) is "
            "not ported yet (ROADMAP Queue 1 item 6); run the program "
            "with is_test=True or dropout_prob=0")
    mask = torch.ones_like(x)
    return {"Out": x * mask, "Mask": mask}


@register_op("concat", inputs=("X",), outputs=("Out",), duplicable=("X",),
             attrs={"axis": 0})
def concat(ins, attrs, device):
    return {"Out": torch.cat(list(ins["X"]), dim=attrs["axis"])}


@register_op("slice", inputs=("Input",), outputs=("Out",),
             attrs={"axes": REQUIRED, "starts": REQUIRED, "ends": REQUIRED})
def slice_op(ins, attrs, device):
    """Starts and ends count from the end when negative and are clamped
    to ``[0, dim]``, as in the JAX op."""
    x = ins["Input"]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": x[tuple(idx)]}


@register_op("one_hot", inputs=("X",), outputs=("Out",),
             attrs={"depth": REQUIRED, "dtype": "float32"},
             differentiable=False)
def one_hot(ins, attrs, device):
    """``jax.nn.one_hot``: ids compared with an ``arange``, so an id out
    of range or negative gives a zero row (``F.one_hot`` would raise, and
    on a card assert)."""
    x = ins["X"]
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    x = x.to(torch.int32)
    classes = torch.arange(attrs["depth"], dtype=torch.int32,
                           device=x.device)
    return {"Out": (x.unsqueeze(-1) == classes).to(
        to_torch_dtype(attrs["dtype"]))}


@register_op("pad", inputs=("X",), outputs=("Out",),
             attrs={"paddings": REQUIRED, "pad_value": 0.0})
def pad(ins, attrs, device):
    """``paddings`` holds a (before, after) pair per dim, first dim
    first; ``F.pad`` takes them last dim first."""
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(len(p) // 2)]
    flat = [n for pair in reversed(pairs) for n in pair]
    return {"Out": torch.nn.functional.pad(ins["X"], flat,
                                           value=attrs["pad_value"])}


# jnp.pad's modes by torch's names: jnp's "edge" repeats the border
# element (torch's "replicate"); both "reflect"s leave the edge out
_PAD2D_MODES = {"constant": "constant", "reflect": "reflect",
                "edge": "replicate"}


@register_op("pad2d", inputs=("X",), outputs=("Out",),
             attrs={"paddings": REQUIRED, "mode": "constant",
                    "pad_value": 0.0, "data_format": "NCHW"})
def pad2d(ins, attrs, device):
    """``paddings`` is [top, bottom, left, right] in both layouts; an
    NHWC tensor is padded as an NCHW view of it."""
    top, bottom, left, right = attrs["paddings"]
    mode = _PAD2D_MODES[attrs["mode"]]
    x = ins["X"]
    nhwc = attrs["data_format"] != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    kw = {"value": attrs["pad_value"]} if mode == "constant" else {}
    out = torch.nn.functional.pad(x, [left, right, top, bottom], mode=mode,
                                  **kw)
    return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}
