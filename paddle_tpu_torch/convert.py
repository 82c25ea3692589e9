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
from paddle_tpu_torch.core.types import from_numpy, to_numpy


def params_from_numpy(named: dict, scope: Scope, device) -> Scope:
    """Put ``{name: ndarray}`` into ``scope`` as tensors on ``device``."""
    device = torch.device(device)
    for name, arr in named.items():
        scope.var(name).set(from_numpy(np.array(arr), name).to(device))
    return scope


def params_to_numpy(scope: Scope, names) -> dict:
    """``{name: ndarray}`` of the named scope tensors, copied to the
    host: parameters, optimizer moments, beta pows, grads."""
    out = {}
    for name in names:
        var = scope.find_var(name)
        if var is None or var.get() is None:
            raise KeyError(f"scope has no value for '{name}'")
        out[name] = to_numpy(var.get(), name)
    return out


def params_from_dir(dirname, params_filename="__params__") -> dict:
    """{name: ndarray} from the ``__params__.npz`` archive that either
    package's ``save_inference_model`` wrote into ``dirname``."""
    path = os.path.join(dirname, params_filename)
    if not os.path.exists(path):
        path += ".npz"
    with np.load(path, allow_pickle=False) as data:
        return {n: data[n] for n in data.files}


def tiny_decode_lm_from_numpy(params, device="cuda", dtype=None):
    """A ``serving.TinyDecodeLM`` holding the JAX package's weights:
    ``params`` maps ``embed``, ``wq``, ``wk``, ``wv`` and ``wo`` to numpy
    arrays (``np.asarray`` of the JAX model's attributes).  The head
    count is not in the weights: it comes from ``params["num_heads"]``
    (default 4, the JAX model's)."""
    from paddle_tpu_torch.serving.decode_engine import TinyDecodeLM

    embed = np.asarray(params["embed"])
    wq = np.asarray(params["wq"])
    num_heads = int(params.get("num_heads", 4))
    model = TinyDecodeLM(vocab=embed.shape[0], d_model=embed.shape[1],
                         num_heads=num_heads,
                         head_dim=wq.shape[1] // num_heads, device=device,
                         dtype=dtype)
    with torch.no_grad():
        for name in ("embed", "wq", "wk", "wv", "wo"):
            w = getattr(model, name)
            w.copy_(torch.from_numpy(
                np.array(params[name], np.float32)).to(w.dtype))
    return model


def int8_state_from_numpy(quant_weights, act_scales=None):
    """The int8 program's state carried across as numpy: ``quant_weights``
    ({param: (int8 weights, f32 scale)}, from either package's
    ``quantize_weights_abs_max`` or ``post_training_quantize``) and
    ``act_scales`` ({activation: abs-max}) as ``({param: (np.int8,
    np.float32)}, {activation: float})``, the form
    ``contrib.slim.quantization.convert_to_int8_execution`` takes.  Both
    packages then run the same int8 program on the same weights and
    scales, whatever each one's f32 calibration would round to."""
    qw = {}
    for name, (q, scale) in quant_weights.items():
        q = np.asarray(q)
        if q.dtype != np.int8:
            raise TypeError(f"int8 weights of '{name}' are {q.dtype}")
        qw[name] = (q, np.asarray(scale, np.float32))
    return qw, {n: float(v) for n, v in (act_scales or {}).items()}
