"""The port's tensor-parallel Predictor against the JAX package's.

``tests/test_sharded_serving.py`` holds the JAX package's sharded replica:
``annotate_tp_inference`` (column-only, with its chain guard),
``carve_slices``, and ``Predictor.shard`` on a tp2 CPU mesh bitwise equal
to the unsharded Predictor.  Here the passes run on both packages'
Predictors of one model saved by the JAX package, and the port's sharded
Predictor runs on a 2-rank gloo cluster (one process a rank) over the
bench's ``serving_tp_sharded`` chain narrowed for the CPU (64 -> 128 x3
relu -> 64 at batch 8): ``torch.equal`` to the lone Predictor, within the
port's Predictor tolerance (``tests/test_torch_inference.py``, 1e-4) of the
JAX sharded Predictor, each rank holding its column block; flag off a
no-op.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax

import paddle_tpu as fluid
from paddle_tpu import inference as jax_inference
from paddle_tpu import layers
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.parallel import gspmd as jgspmd
from torch_port_helpers import run_port_cluster

from paddle_tpu_torch import inference
from paddle_tpu_torch.parallel import gspmd as pgspmd

TOL = 1e-4
CHAIN = dict(in_dim=64, hidden=128, depth=3, out_dim=64, batch=8)


def _save_chain(d, in_dim, hidden, depth, out_dim, head=None):
    """An fc chain saved by the JAX package: ``depth`` relu layers, then
    an fc to ``out_dim`` (then ``head``: "softmax" puts a non-pass-through
    consumer after it)."""
    from paddle_tpu import framework, unique_name
    from paddle_tpu.core.program import Program

    framework.switch_main_program(Program())
    framework.switch_startup_program(Program())
    unique_name.switch({})
    x = layers.data("x", shape=[in_dim], dtype="float32")
    h = x
    for _ in range(depth):
        h = layers.fc(h, size=hidden, act="relu")
    pred = layers.fc(h, size=out_dim)
    if head == "softmax":
        pred = layers.softmax(pred)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(5)
    exe.run(framework.default_startup_program())
    fluid.io.save_inference_model(d, ["x"], [pred], exe)
    return d


def _port_predictor(d):
    cfg = inference.Config(d)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


@pytest.mark.parametrize("model", [
    dict(in_dim=8, hidden=16, depth=1, out_dim=4),     # column-only
    dict(in_dim=8, hidden=16, depth=1, out_dim=1),     # the chain guard
    dict(CHAIN, batch=None),                           # the bench's chain
    dict(in_dim=8, hidden=16, depth=2, out_dim=6, head="softmax"),
    dict(in_dim=8, hidden=15, depth=2, out_dim=4),     # indivisible middle
])
def test_annotate_tp_inference_matches_jax(tmp_path, model):
    """Column-only specs and the chain guard, to a fixpoint: the port's
    pass on the port's Predictor gives the JAX pass's names and specs on
    the JAX Predictor of one saved model."""
    model = {k: v for k, v in model.items() if k != "batch"}
    d = _save_chain(str(tmp_path / "m"), **model)
    jp = jax_inference.create_predictor(jax_inference.Config(d))
    pp = _port_predictor(d)
    want = jgspmd.annotate_tp_inference(jp._program,
                                        jgspmd.MeshPlan(dp=1, tp=2))
    got = pgspmd.annotate_tp_inference(pp._program,
                                       pgspmd.MeshPlan(dp=1, tp=2))
    assert got == want
    shard = {n: v.sharding for n, v in
             pp._program.global_block().vars.items() if v.sharding}
    assert shard == {n: v.sharding for n, v in
                     jp._program.global_block().vars.items()
                     if v.sharding}
    assert pgspmd.annotate_tp_inference(
        pp._program, pgspmd.MeshPlan(dp=2, tp=1)) == []


@pytest.mark.parametrize("n,size", [(8, 2), (8, 3), (5, 5), (7, 1)])
def test_carve_slices_matches_jax(n, size):
    devs = list(range(n))
    assert pgspmd.carve_slices(devs, size) == jgspmd.carve_slices(devs,
                                                                   size)


def test_flag_off_shard_is_a_noop(tmp_path):
    """serving_sharded off: shard() returns None, no byte of the program
    changes, the outputs are the same bits, sharding_info is empty."""
    d = _save_chain(str(tmp_path / "m"), 8, 16, 1, 4)
    probe = np.random.RandomState(0).rand(4, 8).astype(np.float32)
    base, = _port_predictor(d).run([probe])
    p = _port_predictor(d)
    before = p._program.to_bytes()
    assert p.shard(pgspmd.MeshPlan(dp=1, tp=2)) is None
    assert p._program.to_bytes() == before
    assert p.sharding_info() == {}
    out, = p.run([probe])
    assert np.array_equal(out, base)


_SCRIPT = r"""
import json, os
import numpy as np, torch
torch.set_num_threads(1)
import paddle_tpu_torch as pt
from paddle_tpu_torch import inference
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.gspmd import MeshPlan

args = json.loads(os.environ["PT_CLUSTER_ARGS"])
rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
penv.init_parallel_env(rank, world, os.environ["PADDLE_COORDINATOR_ENDPOINT"],
                       place=pt.CPUPlace())


def predictor():
    cfg = inference.Config(args["dir"])
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


probe = np.load(args["probe"])
lone = predictor().run([probe])[0]
p = predictor()
pt.set_flags({"serving_sharded": True})
info = p.shard(MeshPlan(dp=1, tp=2))
out = p.run([probe])[0]
again = p.shard(MeshPlan(dp=1, tp=2))
out2 = p.run([probe])[0]
pt.set_flags({"serving_sharded": False})
try:
    p._scope.find_var(info["annotated"][0]).get()
    scope_read = "no-error"
except RuntimeError as e:
    scope_read = type(e).__name__
print("RESULT " + json.dumps({
    "rank": rank, "annotated": info["annotated"],
    "again": again["annotated"], "devices": info["devices"],
    "equal": bool(np.array_equal(out, lone)),
    "equal_again": bool(np.array_equal(out2, lone)),
    "max_diff": float(np.abs(out - lone).max()),
    "out": out.astype(np.float64).tolist(),
    "info": {n: [list(s) for s in v] for n, v in p.sharding_info().items()},
    "scope_read": scope_read}))
penv.shutdown()
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The bench's narrowed chain saved by the JAX package, the JAX
    sharded Predictor's outputs on 2 CPU devices, and one spawn of the
    port's 2-rank cluster."""
    tmp = tmp_path_factory.mktemp("tp_predictor")
    c = CHAIN
    d = _save_chain(str(tmp / "chain"), c["in_dim"], c["hidden"],
                    c["depth"], c["out_dim"])
    probe = np.random.RandomState(0).rand(c["batch"], c["in_dim"]).astype(
        np.float32)
    np.save(str(tmp / "probe.npy"), probe)
    jax_set_flags({"serving_sharded": True})
    try:
        jp = jax_inference.create_predictor(jax_inference.Config(d))
        jp.shard(jgspmd.MeshPlan(dp=1, tp=2), devices=jax.devices()[:2])
        jax_out = np.asarray(jp.run([probe])[0])
    finally:
        jax_set_flags({"serving_sharded": False})
    ranks = run_port_cluster(_SCRIPT, 2, {
        "dir": d, "probe": str(tmp / "probe.npy")}, timeout=300)
    return {"jax": jax_out, "ranks": ranks}


@pytest.mark.parametrize("rank", range(2))
def test_sharded_predictor_bitwise_lone_predictor(sharded, rank):
    """Column-only splits keep every contraction full-width: each rank's
    whole output is torch.equal to the lone Predictor's, twice (shard is
    idempotent)."""
    r = sharded["ranks"][rank]
    assert r["equal"], r["max_diff"]
    assert r["equal_again"]
    assert r["again"] == r["annotated"] and r["devices"] == 2


def test_sharded_predictor_matches_jax_sharded(sharded):
    for r in sharded["ranks"]:
        np.testing.assert_allclose(np.asarray(r["out"]), sharded["jax"],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rank", range(2))
def test_sharding_info_gives_the_blocks(sharded, rank):
    """Each rank keeps its column block of every weight and bias; the
    scope's entry of one refuses a read."""
    r = sharded["ranks"][rank]
    c = CHAIN
    assert len(r["annotated"]) == 2 * (c["depth"] + 1)
    info = r["info"]
    assert info["fc_0.w_0"] == [[None, "tp"], [c["in_dim"], c["hidden"] // 2]]
    assert info["fc_0.b_0"] == [["tp"], [c["hidden"] // 2]]
    assert info["fc_1.w_0"] == [[None, "tp"], [c["hidden"], c["hidden"] // 2]]
    last = f"fc_{c['depth']}.w_0"
    assert info[last] == [[None, "tp"], [c["hidden"], c["out_dim"] // 2]]
    assert r["scope_read"] == "ZeroShardedError"
