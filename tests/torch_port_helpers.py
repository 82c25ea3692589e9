"""Shared pieces of the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (conftest.py) and torch is capped at two threads so the
port's tests sit well beside the JAX suite's workers.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

torch.set_num_threads(2)

# the slice-wide check: a 2-layer, d64, 4-head, vocab-512, seq-64 LM
TINY_LM = dict(vocab_size=512, max_len=64, d_model=64, n_head=4,
               d_inner=128, n_layer=2, dropout_rate=0.0, is_test=True)


@contextlib.contextmanager
def fresh_port_programs():
    """Fresh default programs, global scope and name counters for the
    port (conftest.py's autouse fixture does the same for paddle_tpu)."""
    from paddle_tpu_torch import framework, unique_name
    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.core.program import Program

    old = (framework.switch_main_program(Program()),
           framework.switch_startup_program(Program()),
           unique_name.switch({}), scope_mod._global_scope)
    scope_mod._global_scope = scope_mod.Scope()
    try:
        yield
    finally:
        framework.switch_main_program(old[0])
        framework.switch_startup_program(old[1])
        unique_name.switch(old[2])
        scope_mod._global_scope = old[3]


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x, dtype=np.float32) \
        if str(getattr(x, "dtype", "")) == "bfloat16" else np.asarray(x)


def cut_resnet(pkg, resnet_module, size=32):
    """Logits of a ResNet of ResNet-50's blocks in inference mode, built
    by ``pkg``'s layers and ``resnet_module``'s blocks: a 7x7/2 stem of 8
    channels, the max pool, a stride-2 and an identity bottleneck, the
    average pool and an fc of 10 classes."""
    layers, mod = pkg.layers, resnet_module
    image = layers.data("image", shape=[3, size, size], dtype="float32")
    x = mod._conv_bn(image, 8, 7, stride=2, act="relu", is_test=True)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = mod._bottleneck(x, 4, 2, is_test=True)
    x = mod._bottleneck(x, 4, 1, is_test=True)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=10)


def randomize_bn(main, scope, seed=1, port=False):
    """Every batch norm's statistics and affine terms in ``scope`` drawn
    away from 0 and 1, so a conv+bn fold has something to fold; numpy
    values for the JAX package's scope, tensors for the port's."""
    rng = np.random.RandomState(seed)
    for op in main.global_block().ops:
        if op.type != "batch_norm":
            continue
        for slot, lo, hi in (("Mean", -0.5, 0.5), ("Variance", 0.5, 2.0),
                             ("Scale", 0.5, 1.5), ("Bias", -0.5, 0.5)):
            var = scope.find_var(op.inputs[slot][0])
            value = rng.uniform(lo, hi, tuple(var.get().shape)).astype(
                np.float32)
            var.set(torch.from_numpy(value) if port else value)
