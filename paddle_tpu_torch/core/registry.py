"""Op registry: one torch compute function per op type.

Counterpart of ``paddle_tpu/core/registry.py``: the same
``register_op(type, inputs, outputs, attrs, ...)`` contract, the same
``REQUIRED`` sentinel, attr canonicalisation and typed lookup error, so
a program written by either package names the same ops, slots and
attrs.

compute signature: ``compute(ins: dict, attrs: dict, device) -> dict``
  - ``ins[slot]`` is a tensor for plain slots, a list for duplicable
    slots; optional slots may be missing from the dict.
  - ``device`` is the torch device the op's outputs go to; ops with no
    inputs (fill/random/assign_value) create their tensors there.
  - returns ``{out_slot: tensor_or_list}``.

Shape inference runs the compute on ``meta``-device tensors, where the
JAX package uses ``jax.eval_shape``.

Grad ops: ``get_op_def("<op>_grad")`` synthesises a def from the forward
one, as the JAX package does with ``jax.vjp`` (``_generic_grad_def``).
Its inputs are the forward inputs plus ``<out>@GRAD`` for each forward
output, its outputs ``<in>@GRAD`` for each forward input.  The compute
detaches the float inputs into autograd leaves, re-runs the forward
compute under ``torch.enable_grad()`` and takes ``torch.autograd.grad``
of the outputs that received a cotangent; an input the outputs do not
depend on gets zeros.  The executor runs every op under
``torch.no_grad()``, so this is the only place a graph is built, and it
is dropped when the grad op returns.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import torch

from paddle_tpu_torch.core.types import dtype_name, to_torch_dtype

META = torch.device("meta")
GRAD_SUFFIX = "@GRAD"


class UnknownOpTypeError(KeyError):
    """Typed lookup failure naming the op type.  Subclasses KeyError so
    ``except KeyError`` callers keep working."""

    def __init__(self, type):
        self.op_type = type
        super().__init__(f"op '{type}' is not registered")

    def __str__(self):
        return self.args[0]


class InferShapeError(RuntimeError):
    """Typed shape-inference failure naming op type, slot and var."""

    def __init__(self, op_type, slot=None, var=None, reason=""):
        self.op_type = op_type
        self.slot = slot
        self.var = var
        msg = f"shape inference for op '{op_type}' failed"
        if slot is not None:
            msg += f" on input slot '{slot}'"
        if var is not None:
            msg += f" (var '{var}')"
        if reason:
            msg += f": {reason}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape (dims may be -1) and IR dtype string of a tensor."""

    shape: tuple
    dtype: str


@dataclasses.dataclass
class OpDef:
    type: str
    inputs: tuple
    outputs: tuple
    compute: Callable                  # (ins, attrs, device) -> outs
    attrs: dict                        # name -> default (REQUIRED if mandatory)
    duplicable: frozenset
    optional: frozenset
    differentiable: bool = True
    # stateful ops (optimizers) write one of their inputs: output slot ->
    # input slot.  Informational: the executor stores every output under
    # its own name, which for these ops is the input's name.
    in_place: dict = dataclasses.field(default_factory=dict)
    # host ops run by an executor handler (saves, loads)
    host_only: bool = False

    def canonical_attrs(self, attrs: dict) -> dict:
        out = {}
        for name, default in self.attrs.items():
            if name in attrs:
                out[name] = attrs[name]
            elif default is REQUIRED:
                raise ValueError(
                    f"op {self.type}: required attr '{name}' missing"
                )
            else:
                out[name] = default
        extra = set(attrs) - set(self.attrs)
        if extra:
            raise ValueError(f"op {self.type}: unknown attrs {sorted(extra)}")
        return out


class _Required:
    def __repr__(self):
        return "<REQUIRED>"


REQUIRED = _Required()

_REGISTRY: dict = {}


def register_op(
    type: str,
    inputs: Sequence[str] = (),
    outputs: Sequence[str] = ("Out",),
    attrs: Optional[dict] = None,
    duplicable: Sequence[str] = (),
    optional: Sequence[str] = (),
    differentiable: bool = True,
    in_place: Optional[dict] = None,
    host_only: bool = False,
):
    """Decorator registering ``compute`` as op ``type``."""

    def deco(compute):
        if type in _REGISTRY:
            raise ValueError(f"op '{type}' registered twice")
        _REGISTRY[type] = OpDef(
            type=type,
            inputs=tuple(inputs),
            outputs=tuple(outputs),
            compute=compute,
            attrs=dict(attrs or {}),
            duplicable=frozenset(duplicable),
            optional=frozenset(optional),
            differentiable=differentiable,
            in_place=dict(in_place or {}),
            host_only=host_only,
        )
        return compute

    return deco


def get_op_def(type: str) -> OpDef:
    try:
        return _REGISTRY[type]
    except KeyError:
        if type.endswith("_grad") and type[: -len("_grad")] in _REGISTRY:
            return _generic_grad_def(type[: -len("_grad")])
        raise UnknownOpTypeError(type) from None


def has_op_def(type: str) -> bool:
    if type in _REGISTRY:
        return True
    return type.endswith("_grad") and type[: -len("_grad")] in _REGISTRY


def _slot_is_diff(val) -> bool:
    leaves = val if isinstance(val, (list, tuple)) else [val]
    return bool(leaves) and all(
        isinstance(x, torch.Tensor) and x.is_floating_point()
        for x in leaves)


@functools.lru_cache(maxsize=None)
def _generic_grad_def(fwd_type: str) -> OpDef:
    """Synthesize '<fwd>_grad' from the forward compute with autograd.

    The same slots, duplicable and optional sets as the JAX package's
    vjp-synthesised def (``paddle_tpu/core/registry.py:181-250``).  Like
    its vjp, the grad recomputes the forward op."""
    fwd = get_op_def(fwd_type)
    if not fwd.differentiable:
        raise KeyError(f"op '{fwd_type}' is not differentiable")

    def grad_compute(ins, attrs, device):
        fwd_ins = {s: ins[s] for s in fwd.inputs if s in ins}
        diff = {k: v for k, v in fwd_ins.items() if _slot_is_diff(v)}
        leaves = {
            k: [x.detach().requires_grad_() for x in v]
            if isinstance(v, (list, tuple)) else v.detach().requires_grad_()
            for k, v in diff.items()}
        nondiff = {k: v for k, v in fwd_ins.items() if k not in diff}
        with torch.enable_grad():
            outs = fwd.compute({**leaves, **nondiff}, attrs, device)
        ys, cts = [], []
        for slot in fwd.outputs:
            g = ins.get(slot + GRAD_SUFFIX)
            if slot not in outs or g is None:
                continue         # no upstream grad: a zero cotangent
            y_list, g_list = outs[slot], g
            if not isinstance(y_list, (list, tuple)):
                y_list, g_list = [y_list], [g_list]
            for y, gy in zip(y_list, g_list):
                if not (y.is_floating_point() and y.requires_grad):
                    continue     # no cotangent for int outputs
                if gy.shape != y.shape and tuple(
                        d for d in gy.shape if d != 1) == tuple(
                        d for d in y.shape if d != 1):
                    # squeeze-compatible mismatches only ([] vs [1],
                    # [N,1] vs [N]); anything else raises in autograd
                    gy = gy.reshape(y.shape)
                ys.append(y)
                cts.append(gy)
        flat = [(k, x) for k, v in leaves.items()
                for x in (v if isinstance(v, list) else [v])]
        grads = [None] * len(flat)
        if ys:
            grads = torch.autograd.grad(ys, [x for _, x in flat], cts,
                                        allow_unused=True)
        res = {}
        for (k, x), g in zip(flat, grads):
            g = torch.zeros_like(x) if g is None else g
            if isinstance(leaves[k], list):
                res.setdefault(k + GRAD_SUFFIX, []).append(g)
            else:
                res[k + GRAD_SUFFIX] = g
        return res

    grad_inputs = tuple(fwd.inputs) + tuple(
        s + GRAD_SUFFIX for s in fwd.outputs)
    grad_dup = frozenset(
        list(fwd.duplicable)
        + [s + GRAD_SUFFIX for s in fwd.outputs if s in fwd.duplicable])
    return OpDef(
        type=fwd_type + "_grad",
        inputs=grad_inputs,
        outputs=tuple(s + GRAD_SUFFIX for s in fwd.inputs),
        compute=grad_compute,
        attrs=dict(fwd.attrs),
        duplicable=grad_dup,
        optional=frozenset(grad_inputs) | frozenset(fwd.optional),
        differentiable=False,
    )


# ---------------------------------------------------------------------------
# Shape/dtype inference on meta tensors.  Unknown dims (-1) all get the
# same dummy extent (so two batch-unknown tensors still broadcast); a
# second run with another dummy finds the output dims that depend on an
# unknown input dim, and those are reported as -1.
# ---------------------------------------------------------------------------

def infer_shapes(op_def: OpDef, ins_specs: dict, attrs: dict,
                 strict: bool = True, var_names: Optional[dict] = None):
    """ins_specs: slot -> TensorSpec or list thereof (shapes may hold -1).

    Returns {out_slot: TensorSpec-or-list} or None when inference failed
    on shapes with unknown dims.  A failure on fully known shapes
    raises ``InferShapeError`` in strict mode."""
    had_unknown = [False]

    def sub(spec, dummy):
        shape = tuple(
            dummy if (d is None or d < 0) else d for d in spec.shape
        )
        if shape != tuple(spec.shape):
            had_unknown[0] = True
        return torch.empty(shape, dtype=to_torch_dtype(spec.dtype),
                           device=META)

    def sub_tree(v, dummy):
        if isinstance(v, (list, tuple)):
            return [sub_tree(x, dummy) for x in v]
        return sub(v, dummy)

    def to_spec(v):
        if isinstance(v, (list, tuple)):
            return [to_spec(x) for x in v]
        return TensorSpec(tuple(v.shape), dtype_name(v.dtype))

    def run(dummy):
        shaped = {k: sub_tree(v, dummy) for k, v in ins_specs.items()}
        outs = op_def.compute(shaped, attrs, META)
        return {k: to_spec(v) for k, v in outs.items()}

    try:
        out_a = run(960)
        if not had_unknown[0]:
            return out_a
        out_b = run(1440)
    except Exception as e:
        if strict and not had_unknown[0]:
            slot = None
            var = None
            if isinstance(e, KeyError) and e.args and \
                    e.args[0] in op_def.inputs:
                slot = e.args[0]
                names = (var_names or {}).get(slot) or [None]
                var = names[0]
            raise InferShapeError(
                op_def.type, slot=slot, var=var,
                reason=f"on fully-known input shapes: "
                       f"{type(e).__name__}: {e}") from e
        # dummy extents can mislead shape arithmetic (e.g. reshape)
        return None

    def merge(a, b):
        if isinstance(a, list):
            return [merge(x, y) for x, y in zip(a, b)]
        shape = tuple(
            da if da == db else -1 for da, db in zip(a.shape, b.shape)
        )
        return TensorSpec(shape, a.dtype)

    return {k: merge(out_a[k], out_b[k]) for k in out_a}
