"""``maxpool_grad_algo="compare"`` of the port against the JAX package.

The same numpy inputs go through ``pool2d`` of both registries under the
flag ``maxpool_grad_algo="compare"``: the forward (a max pool) and the
gradient by ``jax.vjp`` and torch autograd with the same cotangent.  The
cases are ``tests/test_maxpool_grad_algo.py``'s (the ResNet-50 stem's
3x3/2 pool in NHWC, NCHW, VGG's 2x2/2 with an odd tail, an overlapping
3x3/1 window), each in f32 and in bf16, plus a ReLU'd input full of ties
(all-zero windows and windows with two equal maxima), where compare
routes the gradient to every maximum and ``sas`` to the first.

Tolerance: exact.  Both sum a window's routed cotangents in f32 in the
same order (the window offsets row-major) and cast once, so the bits
agree; the forward is a max.  On the ties, the port's compare gradient
also differs from its own ``sas`` gradient (a test that compare does not
fall back to the select-and-scatter rule), while both packages' ``sas``
gradients agree; on the tie-free f32 inputs compare and ``sas`` agree
within 1e-5 (overlapping windows sum in other orders: the JAX test's
bar).  Through the framework, a conv + max-pool program
trained 3 SGD steps under the flag gives the same losses in both
packages within 1e-6 (the JAX test's bar against its ``sas`` run).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.flags import set_flags as jax_set_flags
from torch_port_helpers import fresh_port_programs, to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import registry as pt_registry


@contextlib.contextmanager
def algo(name):
    try:
        jax_set_flags({"maxpool_grad_algo": name})
        pt.set_flags({"maxpool_grad_algo": name})
        yield
    finally:
        jax_set_flags({"maxpool_grad_algo": "sas"})
        pt.set_flags({"maxpool_grad_algo": "sas"})


def _ties(shape, fmt):
    """A ReLU'd input: a quarter of it all-zero windows, a block of equal
    positive maxima, the rest rectified noise."""
    rng = np.random.RandomState(3)
    x = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    h, w = (shape[2], shape[3]) if fmt == "NCHW" else (shape[1], shape[2])
    sl = (slice(None), slice(None)) if fmt == "NCHW" else (slice(None),)
    x[sl + (slice(0, h // 2), slice(0, w // 2))] = 0.0
    x[sl + (slice(h // 2, h // 2 + 3), slice(w // 2, w // 2 + 3))] = 1.5
    return x


# (shape, ksize, strides, paddings, data_format, input)
CASES = [
    ((2, 16, 16, 8), 3, 2, 1, "NHWC", "randn"),        # the rn50 stem pool
    ((2, 8, 16, 16), 3, 2, 1, "NCHW", "randn"),
    ((1, 13, 13, 4), 2, 2, 0, "NHWC", "randn"),        # VGG, odd tail
    ((1, 10, 10, 2), 3, 1, 1, "NHWC", "randn"),        # overlap, stride 1
    ((2, 12, 12, 6), 3, 2, 1, "NHWC", "ties"),
    ((2, 6, 12, 12), 3, 2, 1, "NCHW", "ties"),
    ((1, 10, 10, 3), 3, 1, 1, "NHWC", "ties"),
]


def _input(shape, fmt, kind, dtype):
    x = _ties(shape, fmt) if kind == "ties" else \
        np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(jnp.bfloat16).astype(np.float32)
    return x


def _run_jax(x, g, attrs, dtype):
    jdef = jax_registry.get_op_def("pool2d")
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, vjp = jax.vjp(lambda a: jdef.compute(
        {"X": a}, jdef.canonical_attrs(attrs))["Out"], jnp.asarray(x, jd))
    dx, = vjp(jnp.asarray(g, jd))
    return to_numpy(out), to_numpy(dx)


def _run_port(x, g, attrs, dtype):
    pdef = pt_registry.get_op_def("pool2d")
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xt = torch.from_numpy(x).to(td).requires_grad_()
    out = pdef.compute({"X": xt}, pdef.canonical_attrs(attrs),
                       torch.device("cpu"))["Out"]
    dx, = torch.autograd.grad(out, xt, torch.from_numpy(g).to(td))
    assert out.dtype == dx.dtype == td
    return to_numpy(out), to_numpy(dx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(v) for v in c[1:]))
def test_compare_matches_jax(case, dtype):
    shape, k, s, p, fmt, kind = case
    x = _input(shape, fmt, kind, dtype)
    attrs = {"pooling_type": "max", "ksize": [k, k], "strides": [s, s],
             "paddings": [p, p], "data_format": fmt}
    # the cotangent at the output's shape, made once for both packages
    pdef = pt_registry.get_op_def("pool2d")
    out_shape = pdef.compute({"X": torch.from_numpy(x)},
                             pdef.canonical_attrs(attrs),
                             torch.device("cpu"))["Out"].shape
    g = np.random.RandomState(1).standard_normal(tuple(out_shape)) \
        .astype(np.float32)
    if dtype == "bfloat16":
        g = g.astype(jnp.bfloat16).astype(np.float32)
    with algo("compare"):
        j_out, j_dx = _run_jax(x, g, attrs, dtype)
        p_out, p_dx = _run_port(x, g, attrs, dtype)
    np.testing.assert_array_equal(p_out, j_out)
    np.testing.assert_array_equal(p_dx, j_dx)
    _, sas_dx = _run_port(x, g, attrs, dtype)
    _, j_sas = _run_jax(x, g, attrs, dtype)
    np.testing.assert_array_equal(sas_dx, j_sas)
    if kind == "ties":
        # compare routes a tie to every maximum: more nonzero grads
        assert (p_dx != sas_dx).any()
        assert np.count_nonzero(p_dx) > np.count_nonzero(sas_dx)
    elif dtype == "float32":
        # tie-free (randn in bf16 is not: 8 bits of mantissa collide in
        # a window): the same routes, overlapping windows' cotangents
        # summed in another order (the JAX test's bar)
        np.testing.assert_allclose(p_dx, sas_dx, rtol=1e-5, atol=1e-5)


def _conv_pool_losses(pkg, exe):
    layers = pkg.layers
    np.random.seed(0)
    x = layers.data("x", shape=[4, 12, 12], dtype="float32")
    y = layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                      bias_attr=False)
    y = layers.relu(y)
    p = layers.pool2d(y, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    loss = layers.mean(p)
    pkg.optimizer.SGD(0.5).minimize(loss)
    exe.run(pkg.default_startup_program())
    feed = {"x": np.random.RandomState(1).rand(2, 4, 12, 12)
            .astype(np.float32) - 0.5}
    return [float(exe.run(pkg.default_main_program(), feed=feed,
                          fetch_list=[loss])[0]) for _ in range(3)]


def test_flag_routes_pool2d_training(fresh_programs_factory):
    """A conv + ReLU + max-pool program trained under the compare flag:
    the port's losses equal the JAX package's within 1e-6, and fall."""
    with algo("compare"):
        with fresh_programs_factory():
            want = _conv_pool_losses(fluid, fluid.Executor(
                fluid.CPUPlace()))
        with fresh_port_programs():
            got = _conv_pool_losses(pt, pt.Executor(pt.CPUPlace()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[-1] < got[0]
