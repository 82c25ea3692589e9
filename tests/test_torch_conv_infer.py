"""The conv nets' bf16 inference against the JAX package: the bench's
``infer``, ``vgg_infer``, ``vgg_cifar`` and ``rn32_cifar`` legs
(``bench.py:623-661``) and the ``infer`` leg's A/B lever (the conv+bn
fold and ``fuse_conv_epilogue``, where kernel #5's bias, residual and
relu stages run), and the bf16 Predictor.

- Programs: each leg's build (``clone(for_test=True)``; for the lever
  ``InferenceTranspiler().transpile`` and ``fuse_conv_epilogue`` on the
  folded graph; ``nhwc_transpile``; ``bf16_transpile``) gives the JAX
  package's program, ``to_dict`` equal, at the bench's full widths:
  ResNet-50 (224x224, 1000 classes; 182 ops unfolded, 64 folded and
  fused with 53 ``conv2d_epilogue``), VGG16 (57 ops, its dropouts and
  the batch norm of the first fc's 2-D output among them), VGG16 and
  ResNet-32 on cifar.
- Logits at batch 2, bf16 against bf16 and against the f32 graph, held
  to ``BF16_LOGITS_TOL`` of the f32 logits' scale (bf16 keeps 8
  significant bits and rounds at every op, in both packages at other
  points: about eight bf16 steps): ResNet-50 at 64x64 (224x224 costs the
  CPU more than the file's budget; the program above is the full one),
  the cifar nets at their 32x32, and a ResNet of the same blocks folded
  and fused, the JAX side running #5 under its Pallas interpreter and the
  port its plain version (flag ``interpret``), beside the same graph
  unfolded.  The fused graph's f32 logits are also held to the unfused
  graph's within 1e-4 of scale (the fold moves the BN into the weights
  and changes the summation).
- The Predictor (``save_inference_model`` -> ``Config(dir)`` with
  ``enable_mkldnn_bfloat16`` -> ``create_predictor`` -> ``run``) of
  ResNet-32 and of a VGG cut to two blocks with a narrow head serves
  the JAX Predictor's logits within the same bound, on a model saved by
  either package, and both Predictors' programs are ``to_dict`` equal.
"""

from __future__ import annotations

import importlib
import json

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu.inference as jax_inference
from paddle_tpu.contrib.float16 import bf16_transpile as jax_bf16
from paddle_tpu.core.scope import global_scope as jax_scope
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.transpiler import InferenceTranspiler as JaxFold
from paddle_tpu.transpiler import fuse_conv_epilogue as jax_fuse
from paddle_tpu.transpiler import nhwc_transpile as jax_nhwc
from torch_port_helpers import cut_resnet, fresh_port_programs, randomize_bn

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert

jax_resnet = importlib.import_module("paddle_tpu.models.resnet")
jax_vgg = importlib.import_module("paddle_tpu.models.vgg")
port_resnet = importlib.import_module("paddle_tpu_torch.models.resnet")
port_vgg = importlib.import_module("paddle_tpu_torch.models.vgg")

BATCH = 2
# bf16 logits against each other and against f32, as a share of the f32
# logits' scale: about eight bf16 steps (2^-8 each)
BF16_LOGITS_TOL = 0.03
# the folded graph against the unfolded one in f32, as a share of scale
FOLD_TOL = 1e-4


def _pkg(which):
    if which == "jax":
        return dict(pkg=fluid, resnet=jax_resnet, vgg=jax_vgg,
                    fold=lambda p, prot: JaxFold().transpile(
                        p, protected=prot),
                    fuse=jax_fuse, nhwc=jax_nhwc,
                    bf16=lambda p: jax_bf16(p, scope=jax_scope()),
                    scope=jax_scope)
    return dict(pkg=pt, resnet=port_resnet, vgg=port_vgg,
                fold=lambda p, prot: pt.transpiler.InferenceTranspiler()
                .transpile(p, protected=prot),
                fuse=pt.transpiler.fuse_conv_epilogue,
                nhwc=pt.transpiler.nhwc_transpile,
                bf16=lambda p: pt.contrib.float16.bf16_transpile(
                    p, scope=pt.global_scope()),
                scope=pt.global_scope)


def _cut_resnet(k):
    return {"logits": cut_resnet(k["pkg"], k["resnet"])}


def _cut_vgg(k):
    """VGG's blocks cut to two, with the head (dropout, fc, 2-D batch
    norm, dropout, fc, fc) at width 32."""
    layers, mod = k["pkg"].layers, k["vgg"]
    image = layers.data("image", shape=[3, 32, 32], dtype="float32")
    x = mod._conv_block(image, 8, 2, is_test=True)
    x = mod._conv_block(x, 16, 1, is_test=True)
    x = layers.dropout(x, dropout_prob=0.5, is_test=True)
    x = layers.fc(x, size=32, num_flatten_dims=1)
    x = layers.batch_norm(x, act="relu", is_test=True)
    x = layers.dropout(x, dropout_prob=0.5, is_test=True,
                       dropout_implementation="upscale_in_train")
    x = layers.fc(x, size=32, act="relu")
    return {"image": image, "logits": layers.fc(x, size=10)}


LEGS = {
    "infer": lambda k: k["resnet"].resnet50(is_test=True),
    "infer_convep": lambda k: k["resnet"].resnet50(is_test=True),
    "vgg_infer": lambda k: k["vgg"].vgg16(is_test=True),
    "vgg_cifar": lambda k: k["vgg"].vgg(16, class_dim=10,
                                        img_shape=(3, 32, 32),
                                        is_test=True),
    "rn32_cifar": lambda k: k["resnet"].resnet_cifar10(is_test=True),
}


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _build(which, leg, builder, params=None, bf16=True):
    """The bench's sequence for ``leg`` in the current default programs;
    returns (model, inference program, the parameters before the
    passes).  When the leg folds, the JAX side runs its startup and the
    port takes the given parameters."""
    k = _pkg(which)
    model = builder(k)
    main = k["pkg"].default_main_program()
    if leg == "infer_convep":
        if which == "jax":
            exe = fluid.Executor(fluid.CPUPlace())
            np.random.seed(0)
            exe.run(fluid.default_startup_program())
            randomize_bn(main, jax_scope())
            params = _jax_params(main)
        else:
            convert.params_from_numpy(params, pt.global_scope(), "cpu")
    infer = main.clone(for_test=True)
    if leg == "infer_convep":
        protected = [model["logits"].name]
        k["fold"](infer, protected)
        k["fuse"](infer, protected=protected)
    k["nhwc"](infer)
    if bf16:
        k["bf16"](infer)
    return model, infer, params


def _jax_params(main):
    return {v.name: np.asarray(jax_scope().find_var(v.name).get())
            for v in main.persistables() if not v.is_data}


@pytest.mark.parametrize("leg", list(LEGS))
def test_port_builds_the_jax_inference_programs(leg):
    """The bench's legs at full width, to_dict equal, with the op counts
    ROADMAP records."""
    from conftest import _reset_program_state

    _reset_program_state()
    _, jinfer, params = _build("jax", leg, LEGS[leg])
    with fresh_port_programs():
        _, pinfer, _ = _build("port", leg, LEGS[leg], params)
        assert _canon(pinfer) == _canon(jinfer)
        types = [op.type for op in pinfer.global_block().ops]
    n_ops = {"infer": 182, "infer_convep": 64, "vgg_infer": 57,
             "vgg_cifar": 57, "rn32_cifar": 122}[leg]
    assert len(types) == n_ops
    if leg == "infer_convep":
        assert types.count("conv2d_epilogue") == 53
        assert "batch_norm" not in types
    if leg.startswith("vgg"):
        assert types.count("dropout") == 2


def _feed(size, seed=3):
    return np.random.RandomState(seed).rand(BATCH, 3, size, size).astype(
        np.float32)


def _run(which, infer, logits, image):
    """The logits of ``infer`` on ``image`` (and zero labels where the
    program reads them, as the bench feeds), as f32."""
    feed = {"image": image}
    if "label" in infer.global_block().vars:
        feed["label"] = np.zeros((BATCH, 1), np.int64)
    if which == "jax":
        if infer.global_block().var("image").dtype == "bfloat16":
            feed["image"] = image.astype(ml_dtypes.bfloat16)
        out, = fluid.Executor(fluid.CPUPlace()).run(
            infer, feed=feed, fetch_list=[logits])
    else:
        out, = pt.Executor(pt.CPUPlace()).run(infer, feed=feed,
                                              fetch_list=[logits])
    return np.asarray(out).astype(np.float32)


def _bound(got, want, ref32, tol=BF16_LOGITS_TOL):
    scale = float(np.abs(ref32).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# (leg, builder, image size): ResNet-50 at 64x64, the cifar nets at 32x32
RUN_CASES = [
    ("infer", LEGS["infer"], 64),
    ("rn32_cifar", LEGS["rn32_cifar"], 32),
    ("vgg_cifar", LEGS["vgg_cifar"], 32),
]


def _resize(builder, size):
    if size == 224:
        return builder

    def build(k):
        if builder is LEGS["infer"]:
            return k["resnet"].resnet50(is_test=True,
                                        image_shape=(3, size, size))
        return builder(k)
    return build


@pytest.mark.parametrize("leg,builder,size", RUN_CASES,
                         ids=[c[0] for c in RUN_CASES])
def test_bf16_logits_match_jax(leg, builder, size):
    """Each leg's bf16 graph in both packages, from the JAX package's
    weights, against each other and against the port's f32 graph."""
    from conftest import _reset_program_state

    builder = _resize(builder, size)
    _reset_program_state()
    model = builder(_pkg("jax"))
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(0)
    exe.run(fluid.default_startup_program())
    main = fluid.default_main_program()
    randomize_bn(main, jax_scope())
    params = _jax_params(main)
    infer = main.clone(for_test=True)
    jax_nhwc(infer)
    jax_bf16(infer, scope=jax_scope())
    image = _feed(size)
    jout = _run("jax", infer, model["logits"], image)
    outs = {}
    for bf16 in (False, True):
        with fresh_port_programs():
            pmodel, pinfer, _ = _build("port", leg, builder, bf16=False)
            convert.params_from_numpy(params, pt.global_scope(), "cpu")
            if bf16:
                pt.contrib.float16.bf16_transpile(pinfer,
                                                  scope=pt.global_scope())
            outs[bf16] = _run("port", pinfer, pmodel["logits"], image)
    assert np.isfinite(outs[True]).all()
    _bound(outs[True], jout, outs[False])
    _bound(outs[True], outs[False], outs[False])


@pytest.fixture
def conv_epilogue_interpret():
    jax_set_flags({"conv_epilogue": "interpret"})
    pt.set_flags({"conv_epilogue": "interpret"})
    try:
        yield
    finally:
        jax_set_flags({"conv_epilogue": "off"})
        pt.set_flags({"conv_epilogue": "off"})


def test_fused_folded_graph_matches_jax_and_the_unfused_graph(
        conv_epilogue_interpret):
    """The infer leg's lever on a ResNet of the same blocks: fold,
    fuse_conv_epilogue (every conv with its bias, the bottlenecks' last
    conv with the residual add and relu), nhwc, bf16.  The JAX side runs
    #5 under the Pallas interpreter, the port #5's plain version."""
    from conftest import _reset_program_state

    _reset_program_state()
    jmodel, jinfer, params = _build("jax", "infer_convep", _cut_resnet)
    image = _feed(32)
    jout = _run("jax", jinfer, jmodel["logits"], image)
    outs = {}
    for leg, bf16 in (("infer_convep", True), ("infer_convep", False),
                      ("infer", True), ("infer", False)):
        with fresh_port_programs():
            model, infer, _ = _build("port", leg, _cut_resnet, params,
                                     bf16=bf16 and leg == "infer_convep")
            if leg == "infer":
                convert.params_from_numpy(params, pt.global_scope(), "cpu")
                if bf16:
                    pt.contrib.float16.bf16_transpile(
                        infer, scope=pt.global_scope())
            else:
                if bf16:
                    assert _canon(infer) == _canon(jinfer)
                types = [op.type for op in infer.global_block().ops]
                assert types.count("conv2d_epilogue") == 8
                fused = [op for op in infer.global_block().ops
                         if op.type == "conv2d_epilogue"]
                specs = sorted(op.attrs["epilogue"] for op in fused)
                assert specs.count("bias+residual+relu") == 2
                assert specs.count("bias+relu") == 5
                assert specs.count("bias") == 1     # the projection
            outs[(leg, bf16)] = _run("port", infer, model["logits"], image)
    ref32 = outs[("infer", False)]
    assert np.isfinite(outs[("infer_convep", True)]).all()
    _bound(outs[("infer_convep", True)], jout, ref32)
    _bound(outs[("infer_convep", True)], outs[("infer", True)], ref32)
    _bound(outs[("infer_convep", False)], ref32, ref32, tol=FOLD_TOL)


# ---------------------------------------------------------------------------
# the bf16 Predictor
# ---------------------------------------------------------------------------

def _save(which, builder, dirname):
    """Builds, initialises (BN statistics drawn away from 0 and 1) and
    saves an inference model with ``which`` package."""
    k = _pkg(which)
    model = builder(k)
    if which == "jax":
        exe = fluid.Executor(fluid.CPUPlace())
    else:
        exe = pt.Executor(pt.CPUPlace())
    np.random.seed(0)
    exe.run(k["pkg"].default_startup_program())
    randomize_bn(k["pkg"].default_main_program(), k["scope"](),
                  port=which == "port")
    k["pkg"].io.save_inference_model(dirname, ["image"], [model["logits"]],
                                     exe)


def _predictors(dirname):
    jcfg = jax_inference.Config(dirname)
    jcfg.enable_mkldnn_bfloat16()
    jpred = jax_inference.create_predictor(jcfg)
    cfg = pt.inference.Config(dirname)
    cfg.disable_gpu()
    cfg.enable_mkldnn_bfloat16()
    with fresh_port_programs():
        ppred = pt.inference.create_predictor(cfg)
    f32 = pt.inference.Config(dirname)
    f32.disable_gpu()
    with fresh_port_programs():
        p32 = pt.inference.create_predictor(f32)
    return jpred, ppred, p32


PREDICTOR_MODELS = {
    "rn32_cifar": lambda k: k["resnet"].resnet_cifar10(is_test=True),
    "vgg_cut": _cut_vgg,
}


@pytest.mark.parametrize("saved_by", ["jax", "port"])
@pytest.mark.parametrize("model", list(PREDICTOR_MODELS))
def test_bf16_predictor_serves_what_the_jax_predictor_serves(
        tmp_path, model, saved_by):
    from conftest import _reset_program_state

    d = str(tmp_path)
    _reset_program_state()
    if saved_by == "jax":
        _save("jax", PREDICTOR_MODELS[model], d)
    else:
        with fresh_port_programs():
            _save("port", PREDICTOR_MODELS[model], d)
    jpred, ppred, p32 = _predictors(d)
    assert _canon(ppred._program) == _canon(jpred._program)
    assert ppred.feed_specs()["image"][1] == "bfloat16"
    image = _feed(32, seed=4).astype(ml_dtypes.bfloat16)
    pout, = ppred.run([image])
    jout, = jpred.run([image])
    ref32, = p32.run([image.astype(np.float32)])
    assert pout.dtype == np.asarray(jout).dtype == ml_dtypes.bfloat16
    _bound(pout.astype(np.float32), np.asarray(jout).astype(np.float32),
           ref32)
    _bound(pout.astype(np.float32), ref32, ref32)


# ---------------------------------------------------------------------------
# dropout, which VGG's head runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_in_test_mode_matches_jax_bit_for_bit(impl, dtype):
    """x * (1 - p) (a Python float: bf16 stays bf16) or x itself, and a
    Mask of ones: array_equal to the JAX package's op."""
    from paddle_tpu.core import registry as jax_registry
    from paddle_tpu_torch.core import registry as pt_registry

    x = np.random.RandomState(2).standard_normal((3, 5, 4)).astype(
        np.float32)
    attrs = {"dropout_prob": 0.3, "is_test": True,
             "dropout_implementation": impl}
    jdef, pdef = (r.get_op_def("dropout") for r in (jax_registry,
                                                      pt_registry))
    assert (pdef.inputs, pdef.outputs, pdef.optional) == \
        (jdef.inputs, jdef.outputs, jdef.optional)
    assert {k: repr(v) for k, v in pdef.attrs.items()} == \
        {k: repr(v) for k, v in jdef.attrs.items()}
    jx = np.asarray(x).astype(ml_dtypes.bfloat16) if dtype == "bfloat16" \
        else x
    jout = jdef.compute({"X": jnp.asarray(jx)}, jdef.canonical_attrs(attrs))
    pout = pdef.compute({"X": torch.from_numpy(x).to(getattr(torch, dtype))},
                        pdef.canonical_attrs(attrs), torch.device("cpu"))
    for slot in ("Out", "Mask"):
        p = pout[slot]
        assert str(p.dtype) == f"torch.{dtype}", slot
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(jout[slot], np.float32),
                                      err_msg=slot)


def test_dropout_training_mode_is_not_ported():
    """Training dropout draws threefry bits the port cannot match: the
    op with p > 0 and the layer with is_test=False raise
    NotImplementedError naming ROADMAP Queue 1 item 6; at p == 0 the op
    keeps every element."""
    from paddle_tpu_torch.core import registry as pt_registry

    pdef = pt_registry.get_op_def("dropout")
    x = torch.ones((2, 3))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        pdef.compute({"X": x}, pdef.canonical_attrs({}), x.device)
    out = pdef.compute({"X": x}, pdef.canonical_attrs(
        {"dropout_prob": 0.0}), x.device)
    assert torch.equal(out["Out"], x) and torch.equal(out["Mask"], x)
    with fresh_port_programs():
        v = pt.layers.data("v", shape=[3], dtype="float32")
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            pt.layers.dropout(v, dropout_prob=0.5)
