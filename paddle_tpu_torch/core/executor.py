"""Serial op-by-op executor over torch tensors.

Counterpart of ``paddle_tpu/core/executor.py`` (``Executor.run`` and the
interpreter loop, ``:57-267``).  Every op's compute runs eagerly on the
executor's device; feeds are moved there, fetches come back as numpy
when ``return_numpy`` is set (bfloat16 as ``ml_dtypes`` bfloat16
arrays, as the JAX package returns them).

Every op runs under ``torch.no_grad()``: the forward keeps no autograd
graph and no scope tensor requires grad.  Only a synthesised
``<op>_grad`` compute turns grad mode on, inside itself
(``core/registry.py``).  An op's outputs are stored under their own
names; an optimizer's ``ParamOut`` is named after its ``Param``, so the
new tensor replaces the old one in the scope (no update in place).

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


class Executor:
    """Runs a Program's global block op by op on ``place``'s device."""

    def __init__(self, place: Place = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.core.compiler import CompiledProgram

        if program is None:
            program = framework.default_main_program()
        if isinstance(program, CompiledProgram):
            program = program._program
        if scope is None:
            scope = global_scope()
        self._feed_data(program, feed or {}, scope)
        with torch.no_grad():
            for op in program.global_block().ops:
                self._run_op(op, scope)
        return self._fetch(fetch_list or [], scope, return_numpy)

    def _feed_data(self, program: Program, feed, scope: Scope):
        block = program.global_block()
        for name, value in feed.items():
            if not isinstance(value, torch.Tensor):
                value = from_numpy(value, name)
            if block.has_var(name) and block.var(name).dtype is not None:
                value = value.to(to_torch_dtype(block.var(name).dtype))
            scope.var(name).set(value.to(self.device, non_blocking=True))

    def _run_op(self, op, scope: Scope):
        special = _SPECIAL_OPS.get(op.type)
        if special is not None:
            special(op, scope, self.device)
            return
        op_def = get_op_def(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                var = scope.find_var(n)
                vals.append(None if var is None else var.get())
            if slot in op_def.duplicable:
                missing = [n for n, v in zip(names, vals) if v is None]
                if missing:
                    if slot in op_def.optional:
                        continue
                    raise RuntimeError(
                        f"op {op.type}: input slot {slot} vars {missing}"
                        " are unset")
                ins[slot] = vals
            else:
                val = vals[0] if vals else None
                if val is None:
                    if slot in op_def.optional or not names:
                        continue
                    raise RuntimeError(
                        f"op {op.type}: input '{names[0]}' (slot {slot})"
                        " is unset")
                ins[slot] = val
        try:
            outs = op_def.compute(ins, op.attrs, self.device)
        except Exception as e:
            raise RuntimeError(
                f"error running op {op.type} ({op!r}): {e}") from e
        for slot, names in op.outputs.items():
            if slot not in outs:
                continue
            vals = outs[slot]
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for n, v in zip(names, vals):
                scope.var(n).set(v)

    def _fetch(self, fetch_list, scope: Scope, return_numpy):
        results = []
        for f in fetch_list:
            name = f if isinstance(f, str) else f.name
            var = scope.find_var(name)
            if var is None or var.get() is None:
                raise RuntimeError(f"fetch variable '{name}' has no value")
            val = var.get()
            results.append(to_numpy(val, name) if return_numpy else val)
        return results
