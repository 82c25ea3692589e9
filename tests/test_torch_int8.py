"""The int8 inference slice against the JAX package: the bench's
``infer_i8`` and ``infer_i8_inter`` pipeline (``bench.py:768-929``) on a
cut ResNet of the same blocks.

``resnet(is_test=True)`` cut to a 7x7/2 stem of 8 channels, the max pool,
a stride-2 and an identity bottleneck, the average pool and an fc of 10
classes (32x32, batch 2), with every batch norm's statistics drawn away
from 0 and 1 so the fold has something to fold.  Then, in each package:
``clone(for_test=True)``, ``InferenceTranspiler().transpile`` (the
conv+bn fold), ``nhwc_transpile``, ``quantize_weights_abs_max``,
``post_training_quantize`` (8 calibration images; ``fold_boundaries`` in
the interlayer leg) and ``convert_to_int8_execution(out_dtype=
"bfloat16", int8_activations=False|True)``.

- Each pass leaves the two programs ``to_dict`` equal (the converted ones
  built from the JAX package's int8 weights and scales, carried across by
  ``convert.int8_state_from_numpy``, so both run the same int8 program),
  and the interlayer fold's statistics are equal.
- The port's own calibration: every int8 weight within one lattice step
  of the JAX package's (the fold's f32 filters part in the last bits:
  numpy on both sides, but the BN statistics enter through each
  package's scope), the scales within 1e-6 relative; the activation
  scales within 1e-5 relative; the bench's coverage gate (>= 0.9 of the
  int8 ops with a static InScale) holds.
- Logits: the port runs the converted program with the JAX scope's
  converted state.  Every int8 product is exact and the f32 epilogue
  keeps the JAX op order, so logits are ``array_equal``.  (The float
  reductions between the int8 ops, the average pool among them, could
  round differently in XLA and PyTorch and move an input of
  ``mul_int8``'s quantisation across a rounding boundary; at these
  inputs none does.)
- The interlayer graph's logits equal the non-interlayer graph's,
  bit for bit, in the port (the JAX package asserts the same).
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib.slim import quantization as jax_slim
from paddle_tpu.core.scope import global_scope as jax_scope
from paddle_tpu.transpiler import InferenceTranspiler as JaxFold
from paddle_tpu.transpiler import nhwc_transpile as jax_nhwc
from torch_port_helpers import cut_resnet, fresh_port_programs, randomize_bn

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib.slim import quantization as port_slim

jax_resnet = importlib.import_module("paddle_tpu.models.resnet")
port_resnet = importlib.import_module("paddle_tpu_torch.models.resnet")

BATCH = 2


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _images(seed, n):
    return np.random.RandomState(seed).rand(n, 3, 32, 32).astype(np.float32)


CALIB = [{"image": _images(7, 8)}]
FEED = {"image": _images(1, BATCH)}


def _jax_pipeline(inter):
    """The bench's int8 build in the JAX package: (snapshots by pass,
    int8 weights, activation scales, logits, the converted scope's state
    by name, the starting parameters, the fold statistics, the converted
    program)."""
    from conftest import _reset_program_state

    _reset_program_state()
    logits = cut_resnet(fluid, jax_resnet)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(0)
    exe.run(fluid.default_startup_program())
    main = fluid.default_main_program()
    randomize_bn(main, jax_scope())
    params = {v.name: np.asarray(jax_scope().find_var(v.name).get())
              for v in main.persistables() if not v.is_data}
    infer = main.clone(for_test=True)
    snaps = {}
    JaxFold().transpile(infer, protected=[logits.name])
    snaps["fold"] = _canon(infer)
    jax_nhwc(infer)
    snaps["nhwc"] = _canon(infer)
    qw = jax_slim.quantize_weights_abs_max(infer, jax_scope())
    scales, _ = jax_slim.post_training_quantize(
        infer, jax_scope(), exe, CALIB, fetch_list=[logits],
        fold_boundaries=inter)
    jax_slim.convert_to_int8_execution(
        infer, jax_scope(), qw, act_scales=scales, out_dtype="bfloat16",
        int8_activations=inter, protected=[logits.name])
    snaps["int8"] = _canon(infer)
    out, = exe.run(infer, feed=FEED, fetch_list=[logits])
    state = {v.name: np.asarray(jax_scope().find_var(v.name).get())
             for v in infer.list_vars() if v.persistable
             and jax_scope().find_var(v.name) is not None
             and jax_scope().find_var(v.name).get() is not None}
    return dict(snaps=snaps, qw=qw, scales=scales, logits=np.asarray(out),
                state=state, params=params, infer=infer,
                stats=getattr(infer, "_int8_interlayer_stats", None))


@pytest.fixture(scope="module")
def jax_runs():
    return {inter: _jax_pipeline(inter) for inter in (False, True)}


def _port_pipeline(ref, inter):
    """The same build in the port, checked pass by pass against ``ref``;
    returns (its own int8 weights and scales, the converted program's
    logits with the JAX state, the program)."""
    with fresh_port_programs():
        logits = cut_resnet(pt, port_resnet)
        main = pt.default_main_program()
        scope = pt.global_scope()
        convert.params_from_numpy(ref["params"], scope, "cpu")
        exe = pt.Executor(pt.CPUPlace())
        infer = main.clone(for_test=True)
        pt.transpiler.InferenceTranspiler().transpile(
            infer, protected=[logits.name])
        assert _canon(infer) == ref["snaps"]["fold"]
        pt.transpiler.nhwc_transpile(infer)
        assert _canon(infer) == ref["snaps"]["nhwc"]
        own_qw = port_slim.quantize_weights_abs_max(infer, scope)
        own_scales, _ = port_slim.post_training_quantize(
            infer, scope, exe, CALIB, fetch_list=[logits],
            fold_boundaries=inter)
        qw, scales = convert.int8_state_from_numpy(ref["qw"],
                                                   ref["scales"])
        port_slim.convert_to_int8_execution(
            infer, scope, qw, act_scales=scales, out_dtype="bfloat16",
            int8_activations=inter, protected=[logits.name])
        assert _canon(infer) == ref["snaps"]["int8"]
        assert getattr(infer, "_int8_interlayer_stats", None) == \
            ref["stats"]
        convert.params_from_numpy(ref["state"], scope, "cpu")
        out, = exe.run(infer, feed=FEED, fetch_list=[logits])
        return own_qw, own_scales, out, infer


@pytest.mark.parametrize("inter", [False, True],
                         ids=["infer_i8", "infer_i8_inter"])
def test_int8_pipeline_matches_jax(jax_runs, inter):
    ref = jax_runs[inter]
    own_qw, own_scales, out, infer = _port_pipeline(ref, inter)
    # the port's own calibration, beside the JAX package's
    assert sorted(own_qw) == sorted(ref["qw"])
    for name, (q, s) in own_qw.items():
        jq, js = ref["qw"][name]
        assert q.dtype == np.int8 and q.shape == jq.shape, name
        assert np.abs(q.astype(int) - jq.astype(int)).max() <= 1, name
        np.testing.assert_allclose(s, js, rtol=1e-6, err_msg=name)
    assert sorted(own_scales) == sorted(ref["scales"])
    for name, s in own_scales.items():
        assert s > 0, name
        np.testing.assert_allclose(s, ref["scales"][name], rtol=1e-5,
                                   err_msg=name)
    ops = [op for op in infer.global_block().ops
           if op.type.endswith("_int8")]
    assert len(ops) == 9     # 8 convolutions and the fc
    assert sum(1 for op in ops if op.inputs.get("InScale")) / len(ops) \
        >= 0.9
    # logits, from the same converted state
    assert out.dtype == ref["logits"].dtype
    np.testing.assert_array_equal(out, ref["logits"])


def test_int8_interlayer_folds_and_keeps_the_logits(jax_runs):
    """The interlayer leg folds every conv -> conv edge of the bottlenecks
    (the residual tails stay float), and its logits are the
    non-interlayer graph's, bit for bit."""
    _, _, plain, _ = _port_pipeline(jax_runs[False], False)
    _, _, folded, infer = _port_pipeline(jax_runs[True], True)
    stats = infer._int8_interlayer_stats
    assert stats["n_edges_folded"] >= 4 and stats["n_int8_inputs"] >= 4
    n_req = sum(1 for op in infer.global_block().ops
                if op.type.endswith("_int8") and op.inputs.get("OutScale"))
    assert n_req == stats["n_edges_folded"]
    np.testing.assert_array_equal(folded, plain)


def test_post_training_quantize_floors_all_zero_scales_once():
    """An activation observed all zero records 1e-8 (not 0.0, which means
    never observed), with one warning a process, as the JAX package."""
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        out = pt.layers.fc(pt.layers.relu(x), size=3)
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        port_slim._warned_zero_scale[0] = False
        feed = [{"x": -np.ones((2, 4), np.float32)}]
        with pytest.warns(UserWarning, match="all-zero"):
            scales, weights = port_slim.post_training_quantize(
                pt.default_main_program(), pt.global_scope(), exe, feed,
                fetch_list=[out])
        relu_out = pt.default_main_program().global_block().ops[0] \
            .outputs["Out"][0]
        assert scales[relu_out] == 1e-8
        assert len(weights) == 1
        (q, s), = weights.values()
        assert q.dtype == np.int8 and np.abs(q).max() == 127


def _nhwc_program(ref):
    """The port's cut ResNet, folded and NHWC, with the JAX package's
    starting parameters in a fresh global scope (call inside
    fresh_port_programs)."""
    logits = cut_resnet(pt, port_resnet)
    convert.params_from_numpy(ref["params"], pt.global_scope(), "cpu")
    infer = pt.default_main_program().clone(for_test=True)
    pt.transpiler.InferenceTranspiler().transpile(infer,
                                                  protected=[logits.name])
    pt.transpiler.nhwc_transpile(infer)
    return logits, infer


def test_dequantize_on_load_matches_jax(jax_runs):
    """convert_to_int8_inference: every quantised weight produced at the
    program's start by dequantize_weight from its int8 copy and scale
    (the fp32 vars dropped); the program is to_dict equal to the JAX
    package's, and so are the logits (the dequantised weights are the
    same f32 products in both; the convolutions then sum in f32 in
    other orders: within 1e-5 of scale)."""
    from conftest import _reset_program_state

    _reset_program_state()
    logits = cut_resnet(fluid, jax_resnet)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(0)
    exe.run(fluid.default_startup_program())
    convert_params = jax_runs[False]["params"]
    for name, value in convert_params.items():
        jax_scope().find_var(name).set(value)
    infer = fluid.default_main_program().clone(for_test=True)
    JaxFold().transpile(infer, protected=[logits.name])
    jax_nhwc(infer)
    qw = jax_slim.quantize_weights_abs_max(infer, jax_scope())
    jax_slim.convert_to_int8_inference(infer, jax_scope(), qw)
    want, = exe.run(infer, feed=FEED, fetch_list=[logits])
    with fresh_port_programs():
        plogits, pinfer = _nhwc_program(jax_runs[False])
        qw_p, _ = convert.int8_state_from_numpy(qw)
        port_slim.convert_to_int8_inference(pinfer, pt.global_scope(),
                                            qw_p)
        assert _canon(pinfer) == _canon(infer)
        types = [op.type for op in pinfer.global_block().ops]
        assert types[:len(qw)] == ["dequantize_weight"] * len(qw)
        assert all(pt.global_scope().find_var(n).get() is None for n in qw)
        got, = pt.Executor(pt.CPUPlace()).run(pinfer, feed=FEED,
                                              fetch_list=[plogits])
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_int8_flags_follow_the_jax_package(jax_runs):
    """int8_interlayer and int8_conv_algo have the JAX package's
    defaults, and convert_to_int8_execution(int8_activations=None)
    reads int8_interlayer, as there."""
    from paddle_tpu.flags import get_flag as jax_get_flag

    for name in ("int8_interlayer", "int8_conv_algo"):
        assert pt.get_flag(name) == jax_get_flag(name)
    ref = jax_runs[True]
    pt.set_flags({"int8_interlayer": True})
    try:
        with fresh_port_programs():
            logits, infer = _nhwc_program(ref)
            qw, scales = convert.int8_state_from_numpy(ref["qw"],
                                                       ref["scales"])
            port_slim.convert_to_int8_execution(
                infer, pt.global_scope(), qw, act_scales=scales,
                out_dtype="bfloat16", protected=[logits.name])
            assert infer._int8_interlayer_stats == ref["stats"]
            assert _canon(infer) == ref["snaps"]["int8"]
    finally:
        pt.set_flags({"int8_interlayer": False})
