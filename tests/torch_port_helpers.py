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


def persistable_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def grad_names(main):
    return sorted(v.name + "@GRAD" for v in main.all_parameters())


def jax_two_steps(main, startup, loss_name, feed):
    """The JAX package's Executor on the CPU: startup from
    ``np.random.seed(0)``, then two steps on ``feed``.  Returns the
    persistables before step 1, (step 1's loss, {grad: array}) and the
    persistables after step 2, all as numpy arrays."""
    import paddle_tpu as fluid
    from paddle_tpu.core.scope import Scope, scope_guard

    exe = fluid.Executor(fluid.CPUPlace())
    names, grads = persistable_names(main), grad_names(main)
    with scope_guard(Scope()):
        np.random.seed(0)
        exe.run(startup)
        scope = fluid.global_scope()
        start = {n: to_numpy(scope.find_var(n).get()) for n in names}
        out = exe.run(main, feed=feed, fetch_list=[loss_name] + grads)
        exe.run(main, feed=feed)
        end = {n: to_numpy(scope.find_var(n).get()) for n in names}
    return start, (float(out[0]), dict(zip(grads, out[1:]))), end


def port_two_steps(main, loss_name, feed, init, compiled=False):
    """The port's Executor on the CPU from the persistables ``init``
    (numpy, by name), interpreted or through ``CompiledProgram``: step 1
    fetching the loss and every grad, then step 2.  Returns (step 1's
    loss, {grad: array}) and the persistables after step 2 as tensors."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert

    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    convert.params_from_numpy(init, scope, "cpu")
    prog = pt.CompiledProgram(main) if compiled else main
    grads = grad_names(main)
    out = exe.run(prog, feed=feed, fetch_list=[loss_name] + grads,
                  scope=scope)
    exe.run(prog, feed=feed, scope=scope)
    leaked = [n for n, v in scope.vars.items()
              if isinstance(v.get(), torch.Tensor)
              and (v.get().requires_grad or v.get().grad_fn is not None)]
    assert leaked == []
    end = {n: scope.find_var(n).get().clone()
           for n in persistable_names(main)}
    return (float(out[0]), dict(zip(grads, out[1:]))), end


def assert_same_two_steps(got, want, loss_rtol, grad_tol, param_atol,
                          moment_tol):
    """Step 1's loss within ``loss_rtol``, each grad within ``grad_tol``
    of its largest magnitude, each parameter after step 2 within
    ``param_atol`` and each optimizer accumulator within ``moment_tol``
    (relative and absolute)."""
    (p_loss, p_grads), p_end = got
    (j_loss, j_grads), j_end = want
    assert np.isfinite(p_loss)
    np.testing.assert_allclose(p_loss, j_loss, rtol=loss_rtol)
    assert sorted(p_grads) == sorted(j_grads)
    for name, j in j_grads.items():
        p, j = to_numpy(p_grads[name]), to_numpy(j)
        scale = max(float(np.abs(j).max()), 1e-30)
        np.testing.assert_allclose(p, j, rtol=0, atol=grad_tol * scale,
                                   err_msg=name)
    assert sorted(p_end) == sorted(j_end)
    for name, j in j_end.items():
        p = to_numpy(p_end[name])
        acc = "_moment" in name or "_beta" in name
        np.testing.assert_allclose(
            p, to_numpy(j), rtol=moment_tol if acc else 0,
            atol=moment_tol if acc else param_atol, err_msg=name)


def assert_compiled_equals_interpreted(main, loss_name, feed, init):
    """Two steps through ``CompiledProgram`` give the interpreter's
    bits: step 1's loss and grads, every persistable after step 2."""
    (a_loss, a_grads), a_end = port_two_steps(main, loss_name, feed, init)
    (b_loss, b_grads), b_end = port_two_steps(main, loss_name, feed, init,
                                              compiled=True)
    assert a_loss == b_loss
    for name in a_grads:
        assert np.array_equal(to_numpy(a_grads[name]),
                              to_numpy(b_grads[name])), name
    for name in a_end:
        assert torch.equal(a_end[name], b_end[name]), name
