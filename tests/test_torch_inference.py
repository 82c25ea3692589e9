"""The serving slice as a whole: a small Transformer LM carried between
the JAX package and the port through saved inference models.

A 2-layer, d64, 4-head, vocab-512, seq-64 LM.  Its logits from the port's
CPU Predictor match the JAX Predictor's within atol=rtol=1e-4 (XLA jits
the whole block, the port runs op by op: the same f32 math in another
summation order).
"""

from __future__ import annotations

import json

import ml_dtypes
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.inference as jax_inference
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_model
from torch_port_helpers import TINY_LM, fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.models.transformer import \
    transformer_encoder_model as port_model

TOL = 1e-4
SEQ, VOCAB = TINY_LM["max_len"], TINY_LM["vocab_size"]


def _ids(batch, seed):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (batch, SEQ, 1)).astype(np.int64)


def _port_cpu_predictor(dirname):
    cfg = pt.inference.Config(dirname)
    cfg.disable_gpu()
    return pt.inference.create_predictor(cfg)


def _op_types(program):
    return [op.type for op in program.global_block().ops]


def _save_jax_model(dirname):
    model = jax_model(**TINY_LM)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(0)
    exe.run(fluid.default_startup_program())
    fluid.io.save_inference_model(dirname, ["src_ids"], [model["logits"]],
                                  exe)


def test_port_serves_a_model_the_jax_package_saved(tmp_path):
    d = str(tmp_path)
    _save_jax_model(d)
    jpred = jax_inference.create_predictor(jax_inference.Config(d))
    ppred = _port_cpu_predictor(d)
    assert _op_types(ppred._program) == _op_types(jpred._program)
    assert sorted(set(_op_types(ppred._program))) == sorted([
        "mul", "reshape2", "transpose2", "elementwise_add", "layer_norm",
        "flash_attention", "fused_elemwise_activation", "lookup_table",
        "scale", "assign_value"])
    for seed in (1, 2):
        ids = _ids(2, seed)
        jout, = jpred.run([ids])
        pout, = ppred.run([ids])
        np.testing.assert_allclose(pout, np.asarray(jout), rtol=TOL,
                                   atol=TOL)
    # the archive holds the same arrays the JAX scope held
    from paddle_tpu.core.scope import global_scope as jax_scope

    params = convert.params_from_dir(d)
    assert len(params) == 2 + TINY_LM["n_layer"] * 12
    for name, arr in params.items():
        np.testing.assert_array_equal(
            arr, np.asarray(jax_scope().find_var(name).get()))


def test_jax_package_serves_a_model_the_port_saved(tmp_path):
    d = str(tmp_path)
    with fresh_port_programs():
        model = port_model(**TINY_LM)
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        pt.io.save_inference_model(d, ["src_ids"], [model["logits"]], exe)
    jpred = jax_inference.create_predictor(jax_inference.Config(d))
    ppred = _port_cpu_predictor(d)
    ids = _ids(3, 4)
    jout, = jpred.run([ids])
    pout, = ppred.run([ids])
    np.testing.assert_allclose(pout, np.asarray(jout), rtol=TOL, atol=TOL)
    # the same np.random.seed gives the same parameters in both packages
    other = str(tmp_path / "jax")
    _save_jax_model(other)
    ours, theirs = convert.params_from_dir(d), convert.params_from_dir(other)
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name])


def test_port_front_end_with_weights_carried_across():
    """Build with the port's own layers, take the JAX package's
    initialised parameters through params_from_numpy, run both
    executors on the whole training-shaped graph (logits and loss)."""
    model = jax_model(**TINY_LM)
    jexe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(5)
    jexe.run(fluid.default_startup_program())
    from paddle_tpu.core.scope import global_scope as jax_scope

    named = {v.name: np.asarray(jax_scope().find_var(v.name).get())
             for v in fluid.default_main_program().persistables()
             if not v.is_data}
    feed = {"src_ids": _ids(2, 6), "tgt_label": _ids(2, 7)}
    jlogits, jloss = jexe.run(feed=feed,
                              fetch_list=[model["logits"], model["loss"]])
    with fresh_port_programs():
        pmodel = port_model(**TINY_LM)
        scope = pt.Scope()
        convert.params_from_numpy(named, scope, "cpu")
        persist = {v.name for v in pt.default_main_program().persistables()
                   if not v.is_data}
        assert persist == set(named)
        plogits, ploss = pt.Executor(pt.CPUPlace()).run(
            feed=feed, fetch_list=[pmodel["logits"], pmodel["loss"]],
            scope=scope)
    np.testing.assert_allclose(plogits, np.asarray(jlogits), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ploss, np.asarray(jloss), rtol=TOL, atol=TOL)


def test_predictor_validates_feeds_and_fills_handles(tmp_path):
    d = str(tmp_path)
    _save_jax_model(d)
    pred = _port_cpu_predictor(d)
    assert pred.get_input_names() == ["src_ids"]
    assert pred.feed_specs() == {"src_ids": ((-1, SEQ, 1), "int64")}
    with pytest.raises(pt.inference.FeedValidationError, match="dtype"):
        pred.run([_ids(1, 0).astype(np.int32)])
    with pytest.raises(pt.inference.FeedValidationError, match="shape"):
        pred.run([_ids(1, 0)[:, :SEQ // 2]])
    with pytest.raises(pt.inference.FeedValidationError, match="missing"):
        pred.validate_feeds({})
    ids = _ids(2, 3)
    pred.get_input_handle("src_ids").copy_from_cpu(ids)
    out, = pred.zero_copy_run()
    name, = pred.get_output_names()
    np.testing.assert_array_equal(
        pred.get_output_handle(name).copy_to_cpu(), out)
    np.testing.assert_array_equal(pred.run([ids])[0], out)


def test_ir_optim_off_keeps_the_unfused_graph(tmp_path):
    d = str(tmp_path)
    _save_jax_model(d)
    cfg = pt.inference.Config(d)
    cfg.disable_gpu()
    cfg.switch_ir_optim(False)
    plain = pt.inference.create_predictor(cfg)
    fused = _port_cpu_predictor(d)
    assert "relu" in _op_types(plain._program)
    assert "fused_elemwise_activation" not in _op_types(plain._program)
    assert _op_types(fused._program).count("fused_elemwise_activation") \
        == TINY_LM["n_layer"]
    ids = _ids(2, 8)
    np.testing.assert_allclose(plain.run([ids])[0], fused.run([ids])[0],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the analysis passes: the conv+bn fold, and the Config knobs
# ---------------------------------------------------------------------------

RN_BATCH = 2
# the fold rewrites the filters in numpy exactly as the JAX package does;
# the logits of 20 convs then differ only in summation order (f32)
RN_TOL = 1e-4
# bf16 logits (8 significant bits, rounded at every one of ~60 ops)
# against each other and against f32, as a share of the logits' scale:
# about 8 bf16 steps (2^-8); the two packages measured 0.7 % apart
BF16_LOGITS_TOL = 0.03


def _save_jax_resnet20(dirname):
    """ResNet-20 (cifar) in test mode, saved by the JAX package, with
    every batch_norm's running statistics and affine terms drawn away
    from 0 and 1 so the fold has something to fold."""
    import importlib

    from paddle_tpu.core.scope import global_scope as jax_scope

    model = importlib.import_module(
        "paddle_tpu.models.resnet").resnet_cifar10(depth=20, is_test=True)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(0)
    exe.run(fluid.default_startup_program())
    rng = np.random.RandomState(1)
    bns = [op for op in fluid.default_main_program().global_block().ops
           if op.type == "batch_norm"]
    for op in bns:
        for slot, lo, hi in (("Mean", -0.5, 0.5), ("Variance", 0.5, 2.0),
                             ("Scale", 0.5, 1.5), ("Bias", -0.5, 0.5)):
            name = op.inputs[slot][0]
            shape = np.asarray(jax_scope().find_var(name).get()).shape
            jax_scope().find_var(name).set(
                rng.uniform(lo, hi, shape).astype(np.float32))
    fluid.io.save_inference_model(dirname, ["image"], [model["logits"]],
                                  exe)
    return len(bns)


def _image(seed):
    return np.random.RandomState(seed).standard_normal(
        (RN_BATCH, 3, 32, 32)).astype(np.float32)


def test_predictor_folds_conv_bn_as_the_jax_predictor(tmp_path):
    d = str(tmp_path)
    n_bn = _save_jax_resnet20(d)
    assert n_bn == 21   # stem, 9 blocks x 2, two projection shortcuts
    jpred = jax_inference.create_predictor(jax_inference.Config(d))
    with fresh_port_programs():
        ppred = _port_cpu_predictor(d)
    assert "batch_norm" not in _op_types(ppred._program)
    assert _op_types(ppred._program).count("conv2d") == n_bn
    assert json.dumps(ppred._program.to_dict(), sort_keys=True) == \
        json.dumps(jpred._program.to_dict(), sort_keys=True)
    # the folded filters and biases, var for var
    folded = [v.name for v in ppred._program.list_vars()
              if v.persistable and ("bn_folded_bias" in v.name
                                    or v.name.startswith("conv2d"))]
    assert len(folded) == 2 * n_bn
    for name in folded:
        np.testing.assert_allclose(
            ppred._scope.find_var(name).get().numpy(),
            np.asarray(jpred._scope.find_var(name).get()),
            rtol=1e-6, atol=1e-6, err_msg=name)
    for seed in (2, 3):
        image = _image(seed)
        pout, = ppred.run([image])
        jout, = jpred.run([image])
        np.testing.assert_allclose(pout, np.asarray(jout), rtol=RN_TOL,
                                   atol=RN_TOL)
    # unfolded, the same model gives the same logits
    cfg = pt.inference.Config(d)
    cfg.disable_gpu()
    cfg.switch_ir_optim(False)
    with fresh_port_programs():
        plain = pt.inference.create_predictor(cfg)
    assert _op_types(plain._program).count("batch_norm") == n_bn
    np.testing.assert_allclose(plain.run([image])[0], pout, rtol=RN_TOL,
                               atol=RN_TOL)


def test_reference_config_script_runs_unchanged(tmp_path):
    """Every knob of the JAX package's Config exists on the port's; the
    recorded no-ops change nothing, and enable_mkldnn_bfloat16 runs the
    program in bf16 as the JAX Predictor does."""
    d = str(tmp_path)
    _save_jax_resnet20(d)

    def configure(cfg):
        cfg.enable_tensorrt_engine(workspace_size=1 << 20, max_batch_size=4)
        cfg.enable_mkldnn()
        cfg.switch_use_feed_fetch_ops(False)
        cfg.enable_memory_optim()
        cfg.disable_glog_info()
        cfg.switch_ir_optim(True)
        return cfg

    image = _image(4)
    base = _port_cpu_predictor(d).run([image])[0]
    cfg = configure(pt.inference.Config(d))
    cfg.disable_gpu()
    with fresh_port_programs():
        knobs = pt.inference.create_predictor(cfg)
    np.testing.assert_array_equal(knobs.run([image])[0], base)

    jcfg = configure(jax_inference.Config(d))
    jcfg.enable_mkldnn_bfloat16()
    jpred = jax_inference.create_predictor(jcfg)
    cfg.enable_mkldnn_bfloat16()
    with fresh_port_programs():
        ppred = pt.inference.create_predictor(cfg)
    assert json.dumps(ppred._program.to_dict(), sort_keys=True) == \
        json.dumps(jpred._program.to_dict(), sort_keys=True)
    assert ppred.feed_specs()["image"][1] == "bfloat16"
    bf16 = image.astype(ml_dtypes.bfloat16)
    pout, = ppred.run([bf16])
    jout = np.asarray(jpred.run([bf16])[0])
    assert pout.dtype == jout.dtype == ml_dtypes.bfloat16
    # bf16 rounds at every op in both packages, at other points: held
    # to the f32 logits' scale, at a few bf16 steps of it
    scale = float(np.abs(base).max())
    np.testing.assert_allclose(pout.astype(np.float32),
                               jout.astype(np.float32), rtol=0,
                               atol=BF16_LOGITS_TOL * scale)
    np.testing.assert_allclose(pout.astype(np.float32), base, rtol=0,
                               atol=BF16_LOGITS_TOL * scale)
