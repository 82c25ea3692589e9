"""Weights carried across from the JAX package.

Parameters travel as numpy arrays keyed by variable name: the names the
JAX package's front end gives are the names the port's front end gives,
so a program built by either package reads them.  Optimizer state
(moments, beta pows, the learning rate) is keyed by name the same way.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from paddle_tpu_torch.core.scope import Scope


def params_from_numpy(named: dict, scope: Scope, device) -> Scope:
    """Put ``{name: ndarray}`` into ``scope`` as tensors on ``device``."""
    device = torch.device(device)
    for name, arr in named.items():
        scope.var(name).set(torch.tensor(np.asarray(arr), device=device))
    return scope


def params_to_numpy(scope: Scope, names) -> dict:
    """``{name: ndarray}`` of the named scope tensors, copied to the
    host: parameters, optimizer moments, beta pows, grads."""
    out = {}
    for name in names:
        var = scope.find_var(name)
        if var is None or var.get() is None:
            raise KeyError(f"scope has no value for '{name}'")
        out[name] = var.get().detach().cpu().numpy()
    return out


def params_from_dir(dirname, params_filename="__params__") -> dict:
    """{name: ndarray} from the ``__params__.npz`` archive that either
    package's ``save_inference_model`` wrote into ``dirname``."""
    path = os.path.join(dirname, params_filename)
    if not os.path.exists(path):
        path += ".npz"
    with np.load(path, allow_pickle=False) as data:
        return {n: data[n] for n in data.files}
