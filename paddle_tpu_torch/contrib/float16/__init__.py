"""bf16 inference transpiler.

Counterpart of ``paddle_tpu/contrib/float16/__init__.py``: casts every
float32 var a program declares, and those vars' values in the scope, to
bfloat16.  No op is rewritten: each op computes in its inputs' dtype, as
XLA propagates types in the JAX package.  ``Config.enable_mkldnn_bfloat16``
runs it on the Predictor's program.
"""

from __future__ import annotations

import torch

__all__ = ["bf16_transpile", "float16_transpile"]


def bf16_transpile(program, place=None, scope=None):
    """Cast every float32 var of ``program`` (and its value in ``scope``)
    to bfloat16; returns the program, modified in place.  Only vars the
    program declares are touched: other state in the scope (optimizer
    moments, master weights) is left alone.  ``place`` is accepted for
    the reference signature and unused."""
    names = set()
    for block in program.blocks:
        for var in block.vars.values():
            names.add(var.name)
            if var.dtype == "float32":
                var.dtype = "bfloat16"
    if scope is not None:
        for name, var in list(scope.vars.items()):
            value = var.get()
            if name in names and isinstance(value, torch.Tensor) and \
                    value.dtype == torch.float32:
                var.set(value.to(torch.bfloat16))
    return program


# the reference's name (it casts to fp16; the port's half type is bf16,
# as the JAX package's)
float16_transpile = bf16_transpile
