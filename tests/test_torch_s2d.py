"""The space-to-depth stem of the port against the JAX package.

- Ops: ``pad`` (a pair a dim, ``pad_value``), ``pad2d`` (every mode, both
  layouts, asymmetric paddings) and ``space_to_depth``: the same slots
  and attr defaults in both registries, then the same numpy inputs
  through both computes and both synthesised grads (one cotangent), in
  f32 and bf16 (inputs rounded to bf16 once).  Tolerance: exact.  Padding
  and space-to-depth move elements, and their grads sum at most one
  cotangent per element, except ``reflect`` and ``edge``, whose grads
  sum the mirrored or repeated elements' cotangents (up to four here):
  f32 within 1e-6 of the scale; bf16 within 2^-6 of each element (jnp
  rounds each partial sum to bf16, torch rounds once: up to four bf16
  steps apart) plus one bf16 step (2^-8) of the scale.  ``F.pixel_unshuffle``
  orders the output channels c b^2 + i b + j where the op has
  (i b + j) C + c: a case shows the two differ on the stem's shape, so
  the comparison with the JAX op would catch that swap.
- The pass ``space_to_depth_stem`` on the stem + head net of
  ``tests/test_layout.py`` (a 7x7/2 stem of 3 channels at 16x16, a 3x3
  conv it must leave alone): the rewritten program ``to_dict`` equal to
  the JAX pass's (the names ``@S2DPAD`` and ``@S2D`` too); one Momentum
  step of the stemmed program (then ``nhwc_transpile``) against the
  unstemmed one in the port, and against the JAX package's stemmed
  program: the loss within rtol 1e-5 (the JAX test's trajectory bar is
  2e-4), the original 7x7 weight's grad within 1e-4 of its scale (the
  stem's 4x4 conv on 12 channels sums the same products in another
  order); the pass raises after ``minimize``.
- ResNet-50 at full width in the bench's three legs (``bench.py``
  ``_build_resnet50_train``, ``s2d=True``): ``resnet50``, the stem, the
  leg's fusion, ``nhwc_transpile``, AMP Momentum; main and startup
  programs ``to_dict`` equal to the JAX package's, with the fused-op
  counts its build gives.
- A small stemmed ResNet (tests/test_torch_resnet.py's, whose 7x7/2 stem
  the pass takes) under each fusion: two steps through CompiledProgram
  equal to the interpreter's bits.
"""

from __future__ import annotations

import contextlib
import importlib
import json
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.transpiler import fuse_conv_bn_train as jax_fuse_conv_bn
from paddle_tpu.transpiler import fuse_conv_epilogue as jax_fuse_conv_ep
from paddle_tpu.transpiler import nhwc_transpile as jax_nhwc
from paddle_tpu.transpiler import space_to_depth_stem as jax_stem
from torch_port_helpers import (assert_compiled_equals_interpreted,
                                fresh_port_programs, persistable_names,
                                to_numpy)

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as pt_registry

jax_resnet = importlib.import_module("paddle_tpu.models.resnet")
port_resnet = importlib.import_module("paddle_tpu_torch.models.resnet")

_rng = np.random.RandomState(21)


def _f(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the ops
# ---------------------------------------------------------------------------

OP_CASES = [
    ("pad", _f(3, 5), {"paddings": [1, 2, 0, 3]}),
    ("pad", _f(2, 3, 4, 5), {"paddings": [0, 0, 1, 0, 2, 1, 0, 3],
                             "pad_value": -1.5}),
    # the stem's filter pad: [O, C, 7, 7] -> [O, C, 8, 8]
    ("pad", _f(4, 3, 7, 7), {"paddings": [0, 0, 0, 0, 1, 0, 1, 0]}),
    ("pad", _f(2, 3, 4), {"paddings": [2, 0, 0, 1, 3, 2], "pad_value": 0.5}),
    ("space_to_depth", _f(2, 3, 8, 6), {"blocksize": 2}),
    ("space_to_depth", _f(1, 2, 9, 6), {"blocksize": 3}),
    ("space_to_depth", _f(4, 3, 8, 8), {"blocksize": 2}),
]
for _mode in ("constant", "reflect", "edge"):
    for _fmt, _shape in (("NCHW", (2, 3, 6, 7)), ("NHWC", (2, 6, 7, 3))):
        OP_CASES.append(("pad2d", _f(*_shape), {
            "paddings": [1, 3, 2, 0], "mode": _mode, "data_format": _fmt,
            **({"pad_value": 0.75} if _mode == "constant" else {})}))
# the stem's image pad: [N, 3, H, W] -> [N, 3, H + 6, W + 6]
OP_CASES.append(("pad2d", _f(2, 3, 10, 12), {"paddings": [4, 2, 4, 2]}))

EXACT_GRAD = {"pad", "space_to_depth"}


def _cases():
    return [pytest.param(op, x, attrs, dt, id=f"{op}-{i}-{dt}")
            for i, (op, x, attrs) in enumerate(OP_CASES)
            for dt in ("float32", "bfloat16")]


def _both(a, dtype):
    if dtype == "bfloat16":
        a = a.astype(jnp.bfloat16).astype(np.float32)
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def test_the_ops_have_the_jax_contract():
    for op in ("pad", "pad2d", "space_to_depth"):
        jdef, pdef = jax_registry.get_op_def(op), pt_registry.get_op_def(op)
        assert (pdef.inputs, pdef.outputs, pdef.duplicable, pdef.optional,
                pdef.differentiable) == (jdef.inputs, jdef.outputs,
                                         jdef.duplicable, jdef.optional,
                                         jdef.differentiable), op
        assert {k: repr(v) for k, v in pdef.attrs.items()} == \
            {k: repr(v) for k, v in jdef.attrs.items()}, op


@pytest.mark.parametrize("op_type,x,attrs,dtype", _cases())
def test_op_and_grad_match_jax(op_type, x, attrs, dtype):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    jx, px = _both(x, dtype)
    jout = jdef.compute({"X": jx}, jdef.canonical_attrs(attrs))["Out"]
    pout = pdef.compute({"X": px}, pdef.canonical_attrs(attrs),
                        torch.device("cpu"))["Out"]
    assert tuple(pout.shape) == tuple(jout.shape)
    assert str(pout.dtype).replace("torch.", "") == str(jout.dtype)
    np.testing.assert_array_equal(to_numpy(pout), to_numpy(jout))
    ct = np.random.RandomState(len(OP_CASES)).standard_normal(
        jout.shape).astype(np.float32)
    jct, pct = _both(ct, dtype)
    jg = jax_registry.get_op_def(op_type + "_grad").compute(
        {"X": jx, "Out@GRAD": jct}, jdef.canonical_attrs(attrs))
    pg = pt_registry.get_op_def(op_type + "_grad").compute(
        {"X": px, "Out@GRAD": pct}, pdef.canonical_attrs(attrs),
        torch.device("cpu"))
    assert set(pg) == set(jg) == {"X@GRAD"}
    p, j = to_numpy(pg["X@GRAD"]), to_numpy(jg["X@GRAD"])
    assert p.shape == j.shape == x.shape
    if op_type in EXACT_GRAD or attrs.get("mode", "constant") == "constant":
        np.testing.assert_array_equal(p, j)
    else:
        scale = float(np.abs(j).max())
        if dtype == "float32":
            np.testing.assert_allclose(p, j, rtol=0, atol=1e-6 * scale)
        else:
            np.testing.assert_allclose(p, j, rtol=2.0 ** -6,
                                       atol=2.0 ** -8 * scale)


def test_pixel_unshuffle_is_not_space_to_depth():
    """On the stem's shape (3 channels, block 2) ``F.pixel_unshuffle``
    gives the channels in another order: the op's comparison with the JAX
    op above would fail on it."""
    x = _f(2, 3, 8, 8)
    want = to_numpy(jax_registry.get_op_def("space_to_depth").compute(
        {"X": jnp.asarray(x)}, {"blocksize": 2})["Out"])
    got = pt_registry.get_op_def("space_to_depth").compute(
        {"X": torch.from_numpy(x)}, {"blocksize": 2},
        torch.device("cpu"))["Out"].numpy()
    swapped = F.pixel_unshuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert swapped.shape == want.shape
    assert not np.array_equal(swapped, want)
    # the same values, channel c b^2 + i b + j against (i b + j) C + c
    perm = [(k % 4) * 3 + k // 4 for k in range(12)]
    np.testing.assert_array_equal(swapped, want[:, perm])


# ---------------------------------------------------------------------------
# (b) the pass on the stem + head net
# ---------------------------------------------------------------------------

def _stem_net(pkg):
    """tests/test_layout.py's stem + head: a 7x7/2/3 stem of 3 channels,
    a 3x3 conv the pass must leave alone."""
    layers = pkg.layers
    img = layers.data("image", shape=[3, 16, 16], dtype="float32")
    lbl = layers.data("label", shape=[1], dtype="int64")
    h = layers.conv2d(img, num_filters=8, filter_size=7, stride=2,
                      padding=3, bias_attr=False)
    h = layers.batch_norm(h, is_test=False)
    h = layers.relu(h)
    h = layers.conv2d(h, num_filters=8, filter_size=3, padding=1,
                      bias_attr=False)
    h = layers.batch_norm(h, is_test=False)
    h = layers.pool2d(h, pool_size=8, pool_type="avg")
    logits = layers.fc(h, size=10)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, lbl))
    return loss


def _stem_batch():
    rng = np.random.RandomState(0)
    return {"image": rng.rand(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _build_stem(pkg, stem, nhwc, use_stem):
    """(loss, the stem conv's original weight name) in the default
    programs: the net, the pass (and nhwc_transpile), Momentum."""
    np.random.seed(13)
    loss = _stem_net(pkg)
    main = pkg.default_main_program()
    weight = next(op.inputs["Filter"][0] for op in main.global_block().ops
                  if op.type == "conv2d")
    if use_stem:
        stem(main)
        nhwc(main)
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    return loss, weight


def _step_jax(loss, weight):
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(13)
    exe.run(fluid.default_startup_program())
    out = exe.run(feed=_stem_batch(), fetch_list=[loss, weight + "@GRAD"])
    return float(out[0]), to_numpy(out[1])


def _step_port(loss, weight):
    exe = pt.Executor(pt.CPUPlace())
    np.random.seed(13)
    exe.run(pt.default_startup_program())
    out = exe.run(feed=_stem_batch(), fetch_list=[loss, weight + "@GRAD"])
    return float(out[0]), to_numpy(out[1])


def test_stem_pass_rewrites_as_the_jax_pass(fresh_programs_factory):
    with fresh_programs_factory():
        _stem_net(fluid)
        jmain = fluid.default_main_program()
        jax_stem(jmain)
        with fresh_port_programs():
            _stem_net(pt)
            pmain = pt.default_main_program()
            pt.transpiler.space_to_depth_stem(pmain)
            assert _canon(pmain) == _canon(jmain)
            ops = pmain.global_block().ops
            types = [op.type for op in ops]
            assert types[:6] == ["pad2d", "space_to_depth", "pad",
                                 "space_to_depth", "conv2d", "batch_norm"]
            stem, other = [op for op in ops if op.type == "conv2d"]
            assert stem.inputs["Input"] == ["image@S2D"]
            assert stem.inputs["Filter"][0].endswith("@S2D")
            assert (stem.attrs["strides"], stem.attrs["paddings"]) == \
                ([1, 1], [0, 0])
            assert (other.attrs["strides"], other.attrs["paddings"]) == \
                ([1, 1], [1, 1])
            assert tuple(pmain.global_block().var("image@S2D").shape) == \
                (-1, 12, 11, 11)
            # nhwc_transpile keeps the chain NCHW: one transpose, at the
            # stem conv's input
            pt.transpiler.nhwc_transpile(pmain)
            jax_nhwc(jmain)
            assert _canon(pmain) == _canon(jmain)
            ops = pmain.global_block().ops
            assert [op.type for op in ops[:5]] == [
                "pad2d", "space_to_depth", "pad", "space_to_depth",
                "transpose"]
            assert ops[4].inputs["X"] == ["image@S2D"]


def test_stemmed_step_matches_unstemmed_and_jax(fresh_programs_factory):
    got = {}
    for use_stem in (False, True):
        with fresh_port_programs():
            got[use_stem] = _step_port(*_build_stem(
                pt, pt.transpiler.space_to_depth_stem,
                pt.transpiler.nhwc_transpile, use_stem))
    with fresh_programs_factory():
        want = _step_jax(*_build_stem(fluid, jax_stem, jax_nhwc, True))
    (loss, grad), (plain_loss, plain_grad) = got[True], got[False]
    assert grad.shape == plain_grad.shape == (8, 3, 7, 7)
    for ref_loss, ref_grad in ((plain_loss, plain_grad), want):
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=1e-4 * float(
            np.abs(ref_grad).max()))


def test_stem_pass_raises_after_minimize():
    with fresh_port_programs():
        loss = _stem_net(pt)
        pt.optimizer.SGD(0.1).minimize(loss)
        with pytest.raises(ValueError, match="space_to_depth_stem must run "
                           "before append_backward"):
            pt.transpiler.space_to_depth_stem(pt.default_main_program())


def test_stem_pass_ignores_non_stem_convs():
    with fresh_port_programs():
        img = pt.layers.data("image", shape=[3, 16, 16], dtype="float32")
        pt.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
        # a 7x7/2 stem on an odd side is no candidate either
        odd = pt.layers.data("odd", shape=[3, 15, 15], dtype="float32")
        pt.layers.conv2d(odd, num_filters=4, filter_size=7, stride=2,
                         padding=3)
        main = pt.default_main_program()
        before = _canon(main)
        pt.transpiler.space_to_depth_stem(main)
        assert _canon(main) == before


# ---------------------------------------------------------------------------
# (c) ResNet-50 with the stem, the bench's three legs
# ---------------------------------------------------------------------------

LEGS = (None, "conv_bn_stats", "conv_epilogue")


def _build_resnet(which, leg, full):
    if which == "jax":
        pkg, mod, stem, nhwc, dec = (fluid, jax_resnet, jax_stem, jax_nhwc,
                                     jax_decorate)
        fuse = {"conv_bn_stats": jax_fuse_conv_bn,
                "conv_epilogue": jax_fuse_conv_ep}
    else:
        pkg, mod, stem, nhwc, dec = (
            pt, port_resnet, pt.transpiler.space_to_depth_stem,
            pt.transpiler.nhwc_transpile,
            pt.contrib.mixed_precision.decorate)
        fuse = {"conv_bn_stats": pt.transpiler.fuse_conv_bn_train,
                "conv_epilogue": pt.transpiler.fuse_conv_epilogue}
    if full:
        model = mod.resnet50(is_test=False)
    else:
        from test_torch_resnet import _small_resnet
        model = _small_resnet(pkg, mod)
    main = pkg.default_main_program()
    stem(main)
    fused = 0
    if leg is not None:
        fused = fuse[leg](main, protected=[model[k].name
                                           for k in ("loss", "logits",
                                                     "acc")])
    nhwc(main)
    dec(pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9),
        init_loss_scaling=1.0, use_dynamic_loss_scaling=False).minimize(
        model["loss"])
    return model, fused


@pytest.mark.parametrize("leg", LEGS, ids=lambda v: v or "plain")
def test_port_builds_the_jax_stemmed_resnet50(leg, fresh_programs_factory):
    with fresh_programs_factory():
        _, j_fused = _build_resnet("jax", leg, True)
        jmain, jstart = fluid.default_main_program(), \
            fluid.default_startup_program()
        with fresh_port_programs():
            _, p_fused = _build_resnet("port", leg, True)
            assert _canon(pt.default_main_program()) == _canon(jmain)
            assert _canon(pt.default_startup_program()) == _canon(jstart)
            types = Counter(op.type for op in
                            pt.default_main_program().global_block().ops)
    assert p_fused == j_fused == (53 if leg == "conv_bn_stats" else 0)
    assert (types["pad2d"], types["pad"], types["space_to_depth"],
            types["transpose"]) == (1, 1, 2, 2)
    if leg == "conv_bn_stats":
        assert types["conv2d_bn_train"] == 53 and types["conv2d"] == 0
    else:
        assert types["conv2d"] == types["batch_norm"] == 53


@contextlib.contextmanager
def _flag(leg, mode):
    try:
        pt.set_flags({leg: mode})
        yield
    finally:
        pt.set_flags({leg: "off"})


@pytest.mark.parametrize("leg", ("conv_bn_stats", "conv_epilogue"))
def test_small_stemmed_resnet_compiled_equals_interpreted(leg):
    rng = np.random.RandomState(5)
    feed = {"image": rng.rand(2, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
    with fresh_port_programs():
        model, _ = _build_resnet("port", leg, False)
        main = pt.default_main_program()
        assert sum(op.type == "space_to_depth"
                   for op in main.global_block().ops) == 2
        scope = pt.Scope()
        np.random.seed(0)
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program(),
                                       scope=scope)
        init = convert.params_to_numpy(scope, persistable_names(main))
        with _flag(leg, "interpret"):
            assert_compiled_equals_interpreted(main, model["loss"].name,
                                               feed, init)
