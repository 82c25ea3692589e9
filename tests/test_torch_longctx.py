"""The bench's long-context legs (``bench.py:998-1046``) against the JAX
package, at seq 256 and 2 heads (the bench runs 8 heads at 32768).

The program: q, k, v ``[1, H, T, D]`` bf16 data vars that take grads,
``flash_attention`` causal, ``loss = reduce_sum(cast(out, f32))`` and
``append_backward``; the fetches are the loss and ``q/k/v@GRAD``.  Each
case runs at D 64 and 128 under both values of the flags the leg sets,
``flash_packed_stats`` and ``flash_head_pack``: they pick a Mosaic layout
of the JAX package's kernels and the port's kernels ignore them, so the
port's results must not move with them.

- Programs: the port's front-end builds the JAX package's program
  (``to_dict`` equal).
- The step: the port's Executor (the kernels' plain versions on the
  CPU) against the JAX Executor (its XLA attention on the CPU), and
  against the JAX package's Pallas kernels run in interpret mode under
  the flags.  Both sides take the same bf16 inputs and round the output
  and the grads to bf16; they accumulate in f32 in other orders, so the
  loss (a sum of 32768-65536 bf16 values) agrees within 1e-2 relative and
  each grad within 2 bf16 steps of its largest magnitude (1.6e-2).
- ``CompiledProgram`` (the plan run eagerly on the CPU) gives the
  interpreter's bits.
"""

from __future__ import annotations

import contextlib
import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import backward as jax_backward
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.ops import pallas_kernels
from torch_port_helpers import fresh_port_programs, to_numpy

import paddle_tpu_torch as pt

HEADS, SEQ = 2, 256
LOSS_RTOL = 1e-2
GRAD_TOL = 1.6e-2
FETCHES = ["q@GRAD", "k@GRAD", "v@GRAD"]
CASES = [pytest.param(d, flag, id=f"d{d}-flags_{flag}")
         for d in (64, 128) for flag in ("off", "on")]


@contextlib.contextmanager
def flash_flags(value):
    """Sets both flags in both packages, as the bench does; restores
    ``off``."""
    flags = {"flash_packed_stats": value, "flash_head_pack": value}
    try:
        jax_set_flags(flags)
        pt.set_flags(flags)
        yield
    finally:
        off = dict.fromkeys(flags, "off")
        jax_set_flags(off)
        pt.set_flags(off)


def build(pkg, backward, d):
    """The bench's program in ``pkg``'s default programs; returns the
    loss."""
    qkv = []
    for n in "qkv":
        x = pkg.layers.data(n, shape=[HEADS, SEQ, d], dtype="bfloat16")
        x.stop_gradient = False
        qkv.append(x)
    out = pkg.layers.flash_attention(*qkv, causal=True)
    loss = pkg.layers.reduce_sum(pkg.layers.cast(out, "float32"))
    backward.append_backward(loss)
    return loss


def feed(d):
    rng = np.random.RandomState(0)
    return {n: rng.randn(1, HEADS, SEQ, d).astype(np.float32).astype(
        ml_dtypes.bfloat16) for n in "qkv"}


def _f32(a):
    return np.asarray(a).astype(np.float32)


def assert_same_step(got, want):
    loss, grads = got[0], got[1:]
    np.testing.assert_allclose(float(loss), float(want[0]), rtol=LOSS_RTOL)
    for name, p, j in zip(FETCHES, grads, want[1:]):
        p, j = _f32(p), _f32(j)
        assert p.shape == j.shape, name
        scale = float(np.abs(j).max())
        err = float(np.abs(p - j).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def run_jax(d):
    loss = build(fluid, jax_backward, d)
    main = fluid.default_main_program()
    exe = fluid.Executor(fluid.CPUPlace())
    with jax_scope_guard(JaxScope()):
        exe.run(fluid.default_startup_program())
        out = exe.run(main, feed=feed(d), fetch_list=[loss] + FETCHES)
    return main, out


def run_port(d, compiled=False):
    with fresh_port_programs():
        loss = build(pt, pt.backward, d)
        main = pt.default_main_program()
        exe = pt.Executor(pt.CPUPlace())
        scope = pt.Scope()
        exe.run(pt.default_startup_program(), scope=scope)
        prog = pt.CompiledProgram(main) if compiled else main
        out = exe.run(prog, feed=feed(d), fetch_list=[loss] + FETCHES,
                      scope=scope)
    return main, out


@pytest.mark.parametrize("d,flag", CASES)
def test_port_runs_the_jax_longctx_program(d, flag):
    with flash_flags(flag):
        jmain, jout = run_jax(d)
        pmain, pout = run_port(d)
    assert json.dumps(pmain.to_dict(), sort_keys=True) == \
        json.dumps(jmain.to_dict(), sort_keys=True)
    types = [op.type for op in pmain.global_block().ops]
    assert types.count("flash_attention") == 1 and \
        "flash_attention_grad" in types and "reduce_sum_grad" in types
    assert all(str(a.dtype) == "bfloat16" for a in pout[1:])
    assert_same_step(pout, jout)


@pytest.mark.parametrize("d,flag", CASES)
def test_longctx_step_matches_the_pallas_kernels(d, flag):
    """The JAX package's Pallas kernels in interpret mode, under the
    flags (head packing applies at D 64: B*H is even), against the
    port's step."""
    f = feed(d)
    q, k, v = (jnp.asarray(f[n]) for n in "qkv")

    def loss_fn(q, k, v):
        out = pallas_kernels.flash_attention(q, k, v, causal=True,
                                             impl="interpret")
        return jnp.sum(out.astype(jnp.float32))

    with flash_flags(flag):
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(q, k, v)
        _, pout = run_port(d)
    assert_same_step(pout, [loss] + [np.asarray(g) for g in grads])


@pytest.mark.parametrize("d", [64, 128])
def test_compiled_longctx_step_equals_interpreted(d):
    _, a = run_port(d)
    _, b = run_port(d, compiled=True)
    for x, y in zip(a, b):
        assert torch.equal(torch.from_numpy(to_numpy(x)),
                           torch.from_numpy(to_numpy(y)))
