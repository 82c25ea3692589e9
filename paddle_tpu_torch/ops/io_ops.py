"""Host IO ops: save_combine / load_combine.

Counterpart of ``paddle_tpu/ops/io_ops.py`` (``:61-93``): one ``.npz``
archive keyed by variable name, the same file either package reads and
writes (bfloat16 as the ``|V2`` records numpy stores an ``ml_dtypes``
bfloat16 array as).  ``load_combine`` places each parameter on the
executor's device once, when the model is loaded.
"""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.core.executor import register_special_op
from paddle_tpu_torch.core.registry import REQUIRED, register_op
from paddle_tpu_torch.core.types import from_numpy, to_numpy


@register_special_op("save_combine")
def save_combine_op(op, block, scope, ctx):
    path = op.attrs["file_path"]
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    arrays = {n: to_numpy(scope.find_var(n).get(), n)
              for n in op.inputs["X"]}
    np.savez(path, **arrays)


@register_op("save_combine", inputs=("X",), outputs=(), duplicable=("X",),
             attrs={"file_path": REQUIRED, "overwrite": True},
             host_only=True, differentiable=False)
def _save_combine_compute(ins, attrs, device):
    return {}


@register_special_op("load_combine")
def load_combine_op(op, block, scope, ctx):
    path = op.attrs["file_path"]
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        for n in op.outputs["Out"]:
            scope.var(n).set(from_numpy(data[n], n).to(ctx.device))


@register_op("load_combine", inputs=(), outputs=("Out",),
             duplicable=("Out",), attrs={"file_path": REQUIRED},
             host_only=True, differentiable=False)
def _load_combine_compute(ins, attrs, device):
    return {}
