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


@register_op("elementwise_add", inputs=("X", "Y"), outputs=("Out",),
             attrs={"axis": -1})
def elementwise_add(ins, attrs, device):
    x, y = _operands(ins, attrs["axis"])
    return {"Out": x + y}


@register_op("elementwise_mul", inputs=("X", "Y"), outputs=("Out",),
             attrs={"axis": -1})
def elementwise_mul(ins, attrs, device):
    x, y = _operands(ins, attrs["axis"])
    return {"Out": x * y}


@register_op("mean", inputs=("X",), outputs=("Out",))
def mean(ins, attrs, device):
    return {"Out": torch.mean(ins["X"])}


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
