"""Each op of the port's serving slice against the JAX package's op.

The same numpy inputs go through ``paddle_tpu``'s registry compute and
``paddle_tpu_torch``'s, one case per op and attr variant.  f32 results
agree within atol=rtol=1e-5 (torch and XLA sum in other orders); random
and constant ops agree exactly.  Also here: the program format shared by
the two packages, the port's isolation from JAX, and its refusal to run
on the CPU unless asked.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import registry as jax_registry
from torch_port_helpers import TINY_LM, fresh_port_programs, to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import registry as pt_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_rng = np.random.RandomState(0)


def _f(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


def _ids(shape, high):
    return _rng.randint(0, high, shape).astype(np.int64)


# (op type, inputs, attrs); every input is a numpy array
OP_CASES = [
    ("fill_constant", {}, {"shape": [3, 4], "value": 1.5}),
    ("uniform_random", {}, {"shape": [5, 6], "min": -0.3, "max": 0.7,
                            "seed": 7}),
    ("uniform_random", {}, {"shape": [4, 3], "seed": 0}),
    ("assign_value", {}, {"values": _f(2, 3), "dtype": "float32"}),
    ("scale", {"X": _f(3, 4)}, {"scale": 2.5, "bias": 0.5}),
    ("scale", {"X": _f(3, 4)}, {"scale": 2.5, "bias": 0.5,
                                "bias_after_scale": False}),
    ("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(2, 3, 4)}, {}),
    ("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(4)}, {"axis": 2}),
    ("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(3)}, {"axis": 1}),
    ("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(1, 3, 4)}, {}),
    ("mul", {"X": _f(2, 3, 4), "Y": _f(4, 5)}, {"x_num_col_dims": 2}),
    ("mul", {"X": _f(2, 3, 4), "Y": _f(12, 5)}, {"x_num_col_dims": 1}),
    ("relu", {"X": _f(3, 5)}, {}),
    ("mean", {"X": _f(3, 5)}, {}),
    ("softmax_with_cross_entropy",
     {"Logits": _f(2, 3, 7), "Label": _ids((2, 3, 1), 7)}, {}),
    ("softmax_with_cross_entropy",
     {"Logits": _f(2, 3, 7), "Label": _ids((2, 3, 1), 3)},
     {"ignore_index": 1}),
    ("softmax_with_cross_entropy",
     {"Logits": _f(4, 6), "Label": np.abs(_f(4, 6))}, {"soft_label": True}),
    ("lookup_table", {"W": _f(10, 4), "Ids": _ids((2, 3, 1), 10)}, {}),
    ("lookup_table", {"W": _f(10, 4), "Ids": _ids((2, 5, 1), 4)},
     {"padding_idx": 2}),
    ("lookup_table", {"W": _f(10, 4),
                      "Ids": np.array([[3], [12], [-1], [-11]], np.int64)},
     {}),
    ("reshape2", {"X": _f(2, 3, 4)}, {"shape": [0, -1]}),
    ("reshape2", {"X": _f(2, 3, 8)}, {"shape": [-1, 3, 2, 4]}),
    ("transpose2", {"X": _f(2, 3, 4, 5)}, {"axis": [0, 2, 1, 3]}),
    ("layer_norm", {"X": _f(2, 3, 8), "Scale": _f(8), "Bias": _f(8)},
     {"begin_norm_axis": 2}),
    ("layer_norm", {"X": _f(2, 3, 8)}, {"begin_norm_axis": 1,
                                       "epsilon": 1e-3}),
    ("fused_elemwise_activation", {"X": _f(2, 3, 4), "Y": _f(4)},
     {"functor_list": ["relu", "elementwise_add"], "axis": 2}),
    ("fused_elemwise_activation", {"X": _f(3, 4), "Y": _f(3, 4)},
     {"functor_list": ["elementwise_add", "relu"]}),
    ("fused_elemwise_activation", {"X": _f(3, 4), "Y": _f(3, 4)},
     {"functor_list": ["scale", "elementwise_mul"], "scale": 0.5}),
    ("fc", {"Input": _f(2, 3, 4), "W": _f(4, 5), "Bias": _f(5)},
     {"in_num_col_dims": 2, "activation_type": "relu"}),
    ("fc", {"Input": _f(6, 4), "W": _f(4, 5)}, {}),
    ("flash_attention", {"Q": _f(2, 2, 24, 16), "K": _f(2, 2, 24, 16),
                         "V": _f(2, 2, 24, 16)}, {"causal": True}),
    ("flash_attention", {"Q": _f(1, 2, 8, 16), "K": _f(1, 2, 20, 16),
                         "V": _f(1, 2, 20, 16)}, {"scale": 0.3}),
]


@pytest.mark.parametrize(
    "op_type,ins,attrs", OP_CASES,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_op_matches_jax(op_type, ins, attrs):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    assert pdef.inputs == jdef.inputs and pdef.outputs == jdef.outputs
    assert {k: repr(v) for k, v in pdef.attrs.items()} == \
        {k: repr(v) for k, v in jdef.attrs.items()}
    jattrs = jdef.canonical_attrs(attrs)
    pattrs = pdef.canonical_attrs(attrs)
    np.random.seed(3)
    jout = jdef.compute({k: jnp.asarray(v) for k, v in ins.items()},
                        jattrs)
    np.random.seed(3)
    pout = pdef.compute({k: torch.from_numpy(v) for k, v in ins.items()},
                        pattrs, torch.device("cpu"))
    assert set(pout) == set(jout)
    for slot in jout:
        j, p = to_numpy(jout[slot]), to_numpy(pout[slot])
        assert j.shape == p.shape, slot
        if op_type in ("fill_constant", "uniform_random", "assign_value"):
            np.testing.assert_array_equal(p, j)
        else:
            np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5,
                                       err_msg=slot)


def test_ops_infer_shapes_on_meta_with_unknown_batch():
    """Shape inference runs each compute on meta tensors; a -1 batch dim
    comes back as -1, exactly as the JAX package infers it."""
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[6, 8])
        y = pt.layers.fc(x, 12, num_flatten_dims=2, act="relu")
        q = pt.layers.transpose(pt.layers.reshape(y, [-1, 6, 3, 4]),
                                [0, 2, 1, 3])
        o = pt.layers.flash_attention(q, q, q, causal=True)
        assert tuple(y.shape) == (-1, 6, 12)
        assert tuple(q.shape) == (-1, 3, 6, 4)
        assert tuple(o.shape) == (-1, 3, 6, 4) and o.dtype == "float32"


# ---------------------------------------------------------------------------
# (c) the program format
# ---------------------------------------------------------------------------

def _canon(d):
    return json.dumps(d, sort_keys=True)


def test_program_dict_round_trips_between_packages(fresh_programs_factory):
    import paddle_tpu as fluid
    from paddle_tpu.core.program import BlockRef as JBlockRef
    from paddle_tpu.core.program import Program as JProgram
    from paddle_tpu.models.transformer import transformer_encoder_model

    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model as port_model

    with fresh_programs_factory():
        transformer_encoder_model(**TINY_LM)
        main = fluid.default_main_program()
        main.global_block().var("src_ids").set_sharding(("dp", None, None))
        jdict = main.to_dict()
        jbytes = main.to_bytes()
    ported = pt.Program.from_dict(jdict)
    assert _canon(ported.to_dict()) == _canon(jdict)
    assert pt.Program.parse_from_bytes(jbytes).to_bytes() == jbytes
    assert ported.global_block().var("src_ids").sharding == \
        ("dp", None, None)
    # for_test clones agree too
    assert _canon(ported.clone(for_test=True).to_dict()) == \
        _canon(JProgram.from_dict(jdict).clone(for_test=True).to_dict())

    with fresh_port_programs():
        port_model(**TINY_LM)
        pdict = pt.default_main_program().to_dict()
    assert _canon(pdict) == _canon(jdict_without_sharding(jdict))
    assert _canon(JProgram.from_dict(pdict).to_dict()) == _canon(pdict)

    # block references and ndarray attrs keep their tags
    jp = JProgram()
    jp.global_block().append_op(
        type="assign_value", outputs={"Out": "c"},
        attrs={"values": np.arange(6, dtype=np.int32).reshape(2, 3),
               "dtype": "int32"}, infer_shape=False)
    jp.global_block().ops[0].attrs["sub_block"] = JBlockRef(0)
    tagged = jp.to_dict()
    back = pt.Program.from_dict(tagged)
    assert back.global_block().ops[0].attrs["sub_block"] == \
        pt.core.program.BlockRef(0)
    assert _canon(back.to_dict()) == _canon(tagged)


def jdict_without_sharding(d):
    d = json.loads(json.dumps(d))
    for b in d["blocks"]:
        for v in b["vars"]:
            v["sharding"] = None
    return d


# ---------------------------------------------------------------------------
# (e) isolation from JAX
# ---------------------------------------------------------------------------

def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_nothing_of_paddle_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'paddle_tpu'\n"
        "             or m.startswith('paddle_tpu.'))\n"
        "print(' '.join(m for m in sys.modules\n"
        "               if m.startswith('paddle_tpu_torch')), '|', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods, bad = res.stdout.split("|", 1)
    assert bad.strip() == "[]"
    mods = mods.split()
    assert len(mods) >= 20
    for m in ("optimizer", "backward", "ops.optim",
              "ops.flash_attention", "flags", "ops.amp", "ops.epilogue",
              "contrib.mixed_precision.decorator",
              "transpiler.epilogue_transpiler", "native", "dataset",
              "reader", "recordio_writer", "data_feed_desc",
              "device_worker", "trainer_desc", "async_executor",
              "communicator", "fleet", "fleet.role_maker",
              "fleet.fleet_wrapper", "distributed.downpour",
              "distributed.downpour_worker", "distributed.ps_instance",
              "distributed.elastic", "contrib.checkpoint", "parallel",
              "parallel.env", "parallel.zero", "ops.collective",
              "core.data_parallel", "transpiler.collective",
              "distributed.collective_server", "launch"):
        assert f"paddle_tpu_torch.{m}" in mods

    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "paddle_tpu"), \
                    f"{path} imports {name}"


# ---------------------------------------------------------------------------
# (f) no silent CPU
# ---------------------------------------------------------------------------

def test_entry_points_refuse_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    from paddle_tpu_torch.models.transformer import \
        transformer_encoder_model

    with fresh_port_programs():
        model = transformer_encoder_model(**TINY_LM)
        with pytest.raises(pt.NoCUDADeviceError, match="CPUPlace"):
            pt.Executor()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        pt.io.save_inference_model(str(tmp_path), ["src_ids"],
                                   [model["logits"]], exe)
    with pytest.raises(pt.NoCUDADeviceError, match="disable_gpu"):
        pt.inference.create_predictor(pt.inference.Config(str(tmp_path)))
    cfg = pt.inference.Config(str(tmp_path))
    cfg.disable_gpu()
    pred = pt.inference.create_predictor(cfg)
    assert pred.device.type == "cpu"
    ids = _ids((1, TINY_LM["max_len"], 1), TINY_LM["vocab_size"])
    out, = pred.run([ids])
    assert out.shape == (1, TINY_LM["max_len"], TINY_LM["vocab_size"])
