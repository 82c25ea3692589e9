"""Serial op-by-op executor over torch tensors.

Counterpart of ``paddle_tpu/core/executor.py`` (``Executor.run`` and the
interpreter loop, ``:57-267``).  Every op's compute runs eagerly on the
executor's device; feeds are moved there, fetches come back as numpy
when ``return_numpy`` is set (bfloat16 as ``ml_dtypes`` bfloat16
arrays, as the JAX package returns them).

A ``CompiledProgram`` goes to its own ``_run`` (the plan and its CUDA
graphs, ``core/compiler.py``); a plain ``Program`` is interpreted here,
the debug path.  Both resolve ops through ``ResolvedOp``, so they run
one contract.

Every op runs under ``torch.no_grad()``: the forward keeps no autograd
graph and no scope tensor requires grad.  Only a synthesised
``<op>_grad`` compute turns grad mode on, inside itself
(``core/registry.py``).  An op's outputs are stored under their own
names; an optimizer's ``ParamOut`` is named after its ``Param``, so here
the new tensor replaces the old one in the scope (no update in place;
the compiled path copies it back into the persistable's fixed buffer).

``Executor()`` with no place means ``CUDAPlace(0)``; resolving it raises
``NoCUDADeviceError`` when no CUDA device is present, so nothing runs on
the CPU unless the caller passed ``CPUPlace()``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.core.scope import Scope, global_scope
from paddle_tpu_torch.core.types import (CUDAPlace, Place, from_numpy,
                                         to_numpy, to_torch_dtype)

# op types executed by a python handler instead of a registry compute
# (host IO: save/load of parameters)
_SPECIAL_OPS: dict = {}


def register_special_op(type: str):
    def deco(fn):
        _SPECIAL_OPS[type] = fn
        return fn

    return deco


class ResolvedOp:
    """One op with its ``OpDef`` and slots looked up once: the contract
    the interpreter and ``CompiledProgram``'s plan share.  ``gather``
    builds the compute's ``ins`` from ``get(name) -> tensor or None``
    (optional and empty slots are left out, a missing input raises),
    ``compute`` runs it, ``scatter`` hands each output to ``put(name,
    tensor)``."""

    __slots__ = ("op", "op_def", "inputs", "outputs")

    def __init__(self, op):
        self.op = op
        self.op_def = op_def = get_op_def(op.type)
        self.inputs = tuple(
            (slot, tuple(names), slot in op_def.duplicable,
             slot in op_def.optional)
            for slot, names in op.inputs.items())
        self.outputs = tuple((slot, tuple(names))
                             for slot, names in op.outputs.items())

    def input_names(self):
        return [n for _, names, _, _ in self.inputs for n in names]

    def output_names(self):
        return [n for _, names in self.outputs for n in names]

    def gather(self, get):
        ins = {}
        for slot, names, duplicable, optional in self.inputs:
            if duplicable:
                vals = [get(n) for n in names]
                missing = [n for n, v in zip(names, vals) if v is None]
                if missing:
                    if optional:
                        continue
                    raise RuntimeError(
                        f"op {self.op.type}: input slot {slot} vars "
                        f"{missing} are unset")
                ins[slot] = vals
            else:
                val = get(names[0]) if names else None
                if val is None:
                    if optional or not names:
                        continue
                    raise RuntimeError(
                        f"op {self.op.type}: input '{names[0]}' (slot "
                        f"{slot}) is unset")
                ins[slot] = val
        return ins

    def compute(self, ins, device):
        try:
            return self.op_def.compute(ins, self.op.attrs, device)
        except Exception as e:
            raise RuntimeError(
                f"error running op {self.op.type} ({self.op!r}): {e}") from e

    def scatter(self, outs, put):
        for slot, names in self.outputs:
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for n, v in zip(names, vals):
                put(n, v)


def _scope_value(scope: Scope, name):
    var = scope.find_var(name)
    return None if var is None else var.get()


class Executor:
    """Runs a Program's global block op by op on ``place``'s device, or
    hands a ``CompiledProgram`` to its own ``_run``."""

    def __init__(self, place: Place = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.core.compiler import CompiledProgram

        if program is None:
            program = framework.default_main_program()
        if scope is None:
            scope = global_scope()
        if isinstance(program, CompiledProgram):
            return program._run(self, dict(feed or {}), fetch_list or [],
                                scope, return_numpy)
        self._feed_data(program, feed or {}, scope)
        with torch.no_grad():
            for op in program.global_block().ops:
                self._run_op(op, scope)
        return self._fetch(fetch_list or [], scope, return_numpy)

    def _feed_data(self, program: Program, feed, scope: Scope):
        for name, value in feed.items():
            scope.var(name).set(feed_tensor(program, name, value).to(
                self.device, non_blocking=True))

    def _run_op(self, op, scope: Scope):
        special = _SPECIAL_OPS.get(op.type)
        if special is not None:
            special(op, scope, self.device)
            return
        rop = ResolvedOp(op)
        outs = rop.compute(rop.gather(lambda n: _scope_value(scope, n)),
                           self.device)
        rop.scatter(outs, lambda n, v: scope.var(n).set(v))

    def _fetch(self, fetch_list, scope: Scope, return_numpy):
        results = []
        for f in fetch_list:
            name = fetch_name(f)
            val = _scope_value(scope, name)
            if val is None:
                raise RuntimeError(f"fetch variable '{name}' has no value")
            results.append(to_numpy(val, name) if return_numpy else val)
        return results


def fetch_name(f) -> str:
    return f if isinstance(f, str) else f.name


def feed_tensor(program: Program, name, value) -> torch.Tensor:
    """Feed ``value`` (an array or a tensor) as a tensor, where it lies,
    in the dtype the program declares for var ``name``."""
    if not isinstance(value, torch.Tensor):
        value = from_numpy(value, name)
    block = program.global_block()
    if block.has_var(name) and block.var(name).dtype is not None:
        value = value.to(to_torch_dtype(block.var(name).dtype))
    return value
