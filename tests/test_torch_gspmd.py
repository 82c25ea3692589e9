"""The port's sharding front-end against the JAX package's.

The JAX package's ``shard_program`` makes one jitted step over its
virtual 8-device CPU mesh (``tests/test_gspmd.py``); here the JAX side
takes the first 4 devices.  The port runs one gloo process a rank
(``run_port_cluster``), each holding its block of every annotated var and
fed its data-axis rows of the global batch.  Programs are built by the
JAX package with the gspmd flag off and carried over by ``to_bytes``; the
port's own passes annotate them.  Parameters come from the JAX startup.

- the passes on a JAX-built program: ``to_dict``-equal annotations and
  tags for dp4 x tp2, dp2 x tp2 and dp2; ``check_sharding``'s diagnostics
  on bad specs; ``MeshPlan`` round trips;
- flag off: ``shard_program`` returns the CompiledProgram untouched, no
  byte of the program changes, and the step is ``torch.equal`` to never
  calling it;
- dp2 x tp2 (4 ranks) and dp1 x tp2 (2 ranks) against the JAX sharded
  step over 3 steps, at ``tests/test_gspmd.py``'s bounds (losses rtol
  2e-5 / atol 1e-6, the two sampled grads 5e-4 / 5e-6, every parameter
  5e-4 / 1e-5); the blocks: ``q.w`` and its first moment (16, 16) on
  dp2 x tp2, the embedding (64, 32);
- ZeRO-3 by spec (``shard_program(MeshPlan(dp=2))``) equal to ZeRO-3 by
  ``zero_sharding_rules(stage=3)``;
- a 2-head model on tp 4 (heads the axis does not divide: q, k and v
  gathered, the kernel on every head) equal to the unsharded step;
- ``make_hybrid_mesh`` and ``shard_map`` against the JAX ones.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as JP

import paddle_tpu as fluid
from paddle_tpu import framework, optimizer
from paddle_tpu.core import scope as jscope_mod
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.models.transformer import transformer_encoder_model
from paddle_tpu.parallel import env as jenv
from paddle_tpu.parallel import gspmd as jgspmd
from paddle_tpu.transpiler import shard_program as jax_shard_program
from torch_port_helpers import fresh_port_programs, run_port_cluster

import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import gspmd as pgspmd

TINY = dict(vocab_size=128, max_len=16, d_model=32, n_head=4,
            d_inner=64, n_layer=2, dropout_rate=0.0, param_prefix="tfm")
GRADS = ["tfm_l0_self_q.w@GRAD", "tfm_out_fc.w@GRAD"]
STEPS = 3


def _feed(step, batch=8):
    rng = np.random.RandomState(100 + step)
    ids = rng.randint(0, TINY["vocab_size"], (batch, 16, 1)).astype(
        np.int64)
    return {"src_ids": ids, "tgt_label": ids}


class _fresh_jax:
    """Fresh default programs of the JAX package, its gspmd flag and mesh
    restored after."""

    def __enter__(self):
        from paddle_tpu import unique_name
        from paddle_tpu.core.program import Program

        self._old = (framework.switch_main_program(Program()),
                     framework.switch_startup_program(Program()),
                     unique_name.switch({}))
        jenv.reset()

    def __exit__(self, *exc):
        from paddle_tpu import unique_name

        jax_set_flags({"gspmd": False})
        jenv.reset()
        framework.switch_main_program(self._old[0])
        framework.switch_startup_program(self._old[1])
        unique_name.switch(self._old[2])


def _jax_tiny(**over):
    """The JAX package's TINY transformer + Adam(1e-3), built flag off:
    (main, startup, loss name)."""
    model = transformer_encoder_model(**dict(TINY, **over))
    optimizer.Adam(1e-3).minimize(model["loss"])
    return (framework.default_main_program(),
            framework.default_startup_program(), model["loss"].name)


def _persistables(main):
    sc = jscope_mod._global_scope
    return {v.name: np.asarray(sc.find_var(v.name).get())
            for v in main.persistables()
            if not v.is_data and sc.find_var(v.name) is not None
            and sc.find_var(v.name).get() is not None}


def _jax_sharded_run(main, startup, loss, plan):
    """The JAX package's sharded step on the first ``plan.size()`` CPU
    devices from a startup seeded 11: (the start's persistables, losses,
    the sampled grads a step, the parameters after)."""
    exe = fluid.Executor(fluid.CPUPlace())
    with jax_scope_guard(JaxScope()):
        np.random.seed(11)
        exe.run(startup)
        start = _persistables(main)
        jax_set_flags({"gspmd": True})
        compiled = jax_shard_program(
            fluid.CompiledProgram(main), plan, loss_name=loss,
            min_size=256, devices=jax.devices()[:plan.size()])
        losses, grads = [], []
        for s in range(STEPS):
            out = exe.run(compiled, feed=_feed(s), fetch_list=[loss] + GRADS)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            grads.append([np.asarray(g) for g in out[1:]])
        sc = jscope_mod._global_scope
        params = {v.name: np.asarray(sc.find_var(v.name).get())
                  for v in main.all_parameters()}
    return start, losses, grads, params


def _write(d, main_bytes, start):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "main.json"), "wb") as f:
        f.write(main_bytes)
    np.savez(os.path.join(d, "start.npz"), **start)
    return d


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

_PRELUDE = r"""
import json, os
import numpy as np, torch
torch.set_num_threads(1)
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel.gspmd import MeshPlan
from paddle_tpu_torch.transpiler import shard_program

args = json.loads(os.environ["PT_CLUSTER_ARGS"])
rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
penv.init_parallel_env(rank, world, os.environ["PADDLE_COORDINATOR_ENDPOINT"],
                       place=pt.CPUPlace())
exe = pt.Executor(pt.CPUPlace())
out = {"rank": rank}
GRADS = ["tfm_l0_self_q.w@GRAD", "tfm_out_fc.w@GRAD"]


def load(d):
    main = pt.Program.parse_from_bytes(open(os.path.join(d, "main.json"),
                                            "rb").read())
    scope = pt.Scope()
    convert.params_from_numpy(dict(np.load(os.path.join(d, "start.npz"))),
                              scope, "cpu")
    return main, scope


def feed(step, batch=8):
    rng = np.random.RandomState(100 + step)
    ids = rng.randint(0, 128, (batch, 16, 1)).astype(np.int64)
    return {"src_ids": ids, "tgt_label": ids}


def lst(a):
    return np.asarray(a, dtype=np.float64).tolist()


def train(d, loss, plan, steps, sharded=True):
    # the JAX-built program, the port's passes and plan; each rank fed its
    # data-axis rows of the global batch
    main, scope = load(d)
    params = [v.name for v in main.all_parameters()]
    prog = pt.CompiledProgram(main)
    if sharded:
        pt.set_flags({"gspmd": True})
        try:
            prog = shard_program(prog, plan, loss_name=loss, min_size=256)
        finally:
            pt.set_flags({"gspmd": False})
    mesh = penv.get_mesh()
    dp = plan.axis_size("dp") if sharded else 1
    di = mesh.axis_index("dp") if sharded else 0
    losses, grads = [], []
    for s in range(steps):
        f = {k: v[di * (8 // dp):(di + 1) * (8 // dp)]
             for k, v in feed(s).items()}
        fetch = [loss] + GRADS + (params if s == steps - 1 else [])
        got = exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
        grads.append([lst(g) for g in got[1:3]])
    final = {n: lst(v) for n, v in zip(params, got[3:])}
    blocks = {n: list(t.shape) for n, t in prog.sharded_state().items()}
    return {"losses": losses, "grads": grads, "params": final,
            "blocks": blocks, "prog": prog, "main": main}
"""

_SCRIPT_4 = _PRELUDE + r"""
# dp2 x tp2 against the JAX sharded step
run = train(args["tiny"], args["loss"], MeshPlan(dp=2, tp=2), 3)
out["dp2tp2"] = {k: run[k] for k in ("losses", "grads", "params", "blocks")}
penv.reset()

# 2 heads on tp 4: q, k and v gathered, the kernel on every head
sharded = train(args["heads2"], args["loss2"], MeshPlan(dp=1, tp=4), 3)
plain = train(args["heads2"], args["loss2"], None, 3, sharded=False)
flash = [op for op in sharded["main"].global_block().ops
         if op.type == "flash_attention"]
final = sharded["prog"]._sharding.final
out["heads2"] = {
    "sharded": {k: sharded[k] for k in ("losses", "params")},
    "plain": {k: plain[k] for k in ("losses", "params")},
    "tags": [op.attrs.get("gspmd_head_axis") for op in flash],
    "flash_out_whole": [final.get(op.outputs["Out"][0]) is None
                        or final[op.outputs["Out"][0]].splits == ()
                        for op in flash],
    "q_block": sharded["blocks"].get("tfm_l0_self_q.w")}
penv.reset()

# make_hybrid_mesh and shard_map on a small array
mesh = penv.make_hybrid_mesh({"dp": 2}, {"tp": 2})
x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)


def f(blk):
    return blk * 2 + penv.all_reduce_sum(blk, mesh.group("tp"), 2)


from paddle_tpu_torch.parallel.zero import PartitionSpec as P
y = penv.shard_map(f, mesh, in_specs=P("dp", "tp"),
                   out_specs=P("dp", "tp"))(x)
out["hybrid"] = {"axis_names": list(mesh.axis_names),
                 "shape": mesh.shape, "y": lst(y)}
penv.shutdown()
print("RESULT " + json.dumps(out))
"""

_SCRIPT_2 = _PRELUDE + r"""
# dp1 x tp2 against the JAX sharded step
run = train(args["tiny"], args["loss"], MeshPlan(dp=1, tp=2), 3)
out["dp1tp2"] = {k: run[k] for k in ("losses", "grads", "params", "blocks")}
penv.reset()

# ZeRO-3 by spec against ZeRO-3 by zero_sharding_rules(stage=3)
from paddle_tpu_torch.parallel.zero import zero_sharding_rules
W = np.random.RandomState(7).randn(16, 1).astype(np.float32)
L = pt.layers
zero3 = {}
for mode in ("gspmd", "zero"):
    penv.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data("x", shape=[16], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        zloss = L.mean(L.square_error_cost(L.fc(x, size=1), y))
        pt.optimizer.Adam(0.05).minimize(zloss)
    sc = pt.Scope()
    np.random.seed(42)
    exe.run(startup, scope=sc)
    if mode == "gspmd":
        pt.set_flags({"gspmd": True})
        try:
            prog = shard_program(pt.CompiledProgram(main), MeshPlan(dp=2),
                                 loss_name=zloss.name, min_size=4)
        finally:
            pt.set_flags({"gspmd": False})
    else:
        mesh = penv.set_mesh(penv.make_mesh(shape=(2,), axis_names=("dp",)))
        prog = pt.CompiledProgram(main).with_data_parallel(
            loss_name=zloss.name, mesh=mesh).with_sharding_rules(
                zero_sharding_rules(stage=3, axis="dp", min_size=4,
                                    program=main))
    r2 = np.random.RandomState(8)
    losses = []
    for _ in range(8):
        bx = r2.rand(32, 16).astype(np.float32)
        mine = slice(rank * 16, (rank + 1) * 16)
        lv, = exe.run(prog, feed={"x": bx[mine], "y": (bx @ W)[mine]},
                      fetch_list=[zloss], scope=sc)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    pname = main.all_parameters()[0].name
    zero3[mode] = {"losses": losses,
                   "rows": list(prog.sharded_state()[pname].shape),
                   "whole": list(main.global_block().var(pname).shape)}
out["zero3"] = zero3
penv.shutdown()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The JAX package's sharded runs and one spawn each of the port's
    4-rank and 2-rank clusters."""
    tmp = str(tmp_path_factory.mktemp("gspmd"))
    jax_runs, args = {}, {}
    for key, plan, over in (("dp2tp2", jgspmd.MeshPlan(dp=2, tp=2), {}),
                            ("dp1tp2", jgspmd.MeshPlan(dp=1, tp=2), {})):
        with _fresh_jax():
            main, startup, loss = _jax_tiny(**over)
            before = main.to_bytes()
            start, losses, grads, params = _jax_sharded_run(
                main, startup, loss, plan)
            jax_runs[key] = {"losses": losses, "grads": grads,
                             "params": params}
            _write(os.path.join(tmp, key), before, start)
            args["loss"] = loss
    with _fresh_jax():
        main, startup, loss2 = _jax_tiny(n_head=2)
        exe = fluid.Executor(fluid.CPUPlace())
        with jax_scope_guard(JaxScope()):
            np.random.seed(11)
            exe.run(startup)
            start = _persistables(main)
        args["heads2"] = _write(os.path.join(tmp, "heads2"),
                                main.to_bytes(), start)
        args["loss2"] = loss2
    four = run_port_cluster(_SCRIPT_4, 4, dict(
        args, tiny=os.path.join(tmp, "dp2tp2")), timeout=600)
    two = run_port_cluster(_SCRIPT_2, 2, dict(
        args, tiny=os.path.join(tmp, "dp1tp2")), timeout=600)
    return {"jax": jax_runs, "four": four, "two": two}


# ---------------------------------------------------------------------------
# the passes, the check and MeshPlan (one process)
# ---------------------------------------------------------------------------

def _annotations(d):
    """The annotations and gspmd tags of a ``to_dict``."""
    blk = d["blocks"][0]
    vars_ = blk["vars"]
    items = vars_.items() if isinstance(vars_, dict) else (
        (v["name"], v) for v in vars_)
    shard = {n: v.get("sharding") for n, v in items if v.get("sharding")}
    tags = [(op["type"], op["attrs"].get("gspmd_batch_axis"),
             op["attrs"].get("gspmd_head_axis")) for op in blk["ops"]
            if op["type"].startswith("flash_attention")]
    return shard, tags


@pytest.mark.parametrize("plan", [dict(dp=4, tp=2), dict(dp=2, tp=2),
                                  dict(dp=2)])
def test_passes_annotate_as_the_jax_package(plan):
    """The port's passes on a JAX-built program: the same annotations and
    attention tags as the JAX package's on the same program."""
    with _fresh_jax():
        main, _, _ = _jax_tiny()
        port = pt.Program.parse_from_bytes(main.to_bytes())
        jplan = jgspmd.MeshPlan(**plan)
        jgspmd.annotate_tp_transformer(main, jplan)
        jgspmd.annotate_zero3(main, jplan, min_size=256)
        n_jax = jgspmd.tag_attention_ops(main, jplan)
    pplan = pgspmd.MeshPlan(**plan)
    tp = pgspmd.annotate_tp_transformer(port, pplan)
    pgspmd.annotate_zero3(port, pplan, min_size=256)
    n_port = pgspmd.tag_attention_ops(port, pplan)
    assert n_port == n_jax
    want, got = _annotations(main.to_dict()), _annotations(port.to_dict())
    assert got == want
    if plan.get("tp", 1) > 1:
        assert "tfm_l0_self_q.w" in tp["column"]
        assert "tfm_l0_ffn_fc2.w" in tp["row"]


def _bad_program(pkg_program, bad):
    gb = pkg_program.global_block()
    name, spec = bad
    gb.vars[name].set_sharding(spec)


@pytest.mark.parametrize("bad", [
    ("tfm_l0_self_q.w", ("bogus", None)),          # unknown axis
    ("tfm_l0_self_q.w", ("tp", "tp")),             # axis reuse
    ("tfm_l0_ffn_fc1.b", ("dp", None)),            # longer than the rank
    ("tfm_emb.w", (("dp", "tp"), None)),           # indivisible: 128 / 24
])
def test_check_sharding_diagnostics_equal(bad):
    """``check_sharding`` gives the JAX package's diagnostics (rule, var,
    message) on a bad spec, and an untagged grad of a tagged forward."""
    from paddle_tpu.analysis.shape_check import check_sharding as jcheck

    from paddle_tpu_torch.analysis.shape_check import (ShardingCheckError,
                                                       check_sharding)

    with _fresh_jax():
        main, _, _ = _jax_tiny()
        port = pt.Program.parse_from_bytes(main.to_bytes())
        jplan = jgspmd.MeshPlan(dp=12, tp=2)
        # a tagged forward, its grads left untagged
        for op in main.global_block().ops:
            if op.type == "flash_attention":
                op.set_attr("gspmd_head_axis", "tp")
        _bad_program(main, bad)
        want = [(d.rule, d.var, d.op_idx, d.severity, str(d))
                for d in jcheck(main, jplan, raise_=False)]
    for op in port.global_block().ops:
        if op.type == "flash_attention":
            op.set_attr("gspmd_head_axis", "tp")
    _bad_program(port, bad)
    pplan = pgspmd.MeshPlan(dp=12, tp=2)
    got = [(d.rule, d.var, d.op_idx, d.severity, str(d))
           for d in check_sharding(port, pplan, raise_=False)]
    assert [g[:4] for g in got] == [w[:4] for w in want]
    assert {g[0] for g in got} >= {"sharding-untagged-grad"}
    with pytest.raises(ShardingCheckError):
        check_sharding(port, pplan)


def test_meshplan_round_trips():
    plan = pgspmd.MeshPlan(dp=4, tp=2)
    assert plan.axis_names == ("dp", "tp", "pp")
    assert plan.shape == (4, 2, 1) and plan.size() == 8
    assert plan.axis_size("tp") == 2 and plan.axis_size("nope") == 1
    assert pgspmd.MeshPlan.from_dict(plan.to_dict()) == plan
    assert plan.to_dict() == jgspmd.MeshPlan(dp=4, tp=2).to_dict()
    assert pgspmd.MeshPlan.from_dict(
        jgspmd.MeshPlan(dp=4, tp=2).to_dict()) == plan
    assert plan.spec("dp", None) == pt.parallel.PartitionSpec("dp", None)
    with pytest.raises(ValueError, match="not in"):
        plan.spec("bogus")
    # one process: a plan of one device builds, any other names the
    # launcher
    with pytest.raises(ValueError, match="needs 3 devices, have 1.*launch"):
        pgspmd.MeshPlan(dp=3).build_mesh()
    one = pgspmd.MeshPlan()
    mesh = one.build_mesh()
    assert mesh.axis_names == ("dp", "tp", "pp")
    assert pgspmd.MeshPlan.from_mesh(mesh) == one


def test_partition_spec_of_and_carve_slices_as_jax():
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[64], dtype="float32")
        pt.layers.fc(x, 32, bias_attr=False)
        w = pt.default_main_program().all_parameters()[0]
        w.set_sharding((("dp", "tp"), None))
        plan = pgspmd.MeshPlan(dp=4, tp=2)
        assert pgspmd.partition_spec_of(w, plan) == \
            pt.parallel.PartitionSpec(("dp", "tp"), None)
        assert pgspmd.partition_spec_of(w, pgspmd.MeshPlan(dp=48)) is None
        with pytest.raises(ValueError, match="not in"):
            pgspmd.partition_spec_of(w, pgspmd.MeshPlan.from_dict(
                {"axes": {"dp": 8}, "data_axis": "dp"}))
    devs = list(range(7))
    assert pgspmd.carve_slices(devs, 2) == jgspmd.carve_slices(devs, 2)
    with pytest.raises(ValueError, match="cannot hold"):
        pgspmd.carve_slices(devs, 8)


def test_flag_off_is_byte_identical_and_bitwise():
    """With the gspmd flag off (its default), ``shard_program`` returns the
    CompiledProgram untouched: no annotation, no attr, no mesh; its step
    is ``torch.equal`` to never calling it."""
    import torch

    from paddle_tpu_torch import convert
    from paddle_tpu_torch.transpiler import shard_program

    with _fresh_jax():
        main, startup, loss = _jax_tiny()
        exe = fluid.Executor(fluid.CPUPlace())
        with jax_scope_guard(JaxScope()):
            np.random.seed(11)
            exe.run(startup)
            start = _persistables(main)
        data = main.to_bytes()
    from paddle_tpu_torch.flags import get_flag

    assert get_flag("gspmd") is False
    runs = []
    for call in (False, True):
        port = pt.Program.parse_from_bytes(data)
        compiled = pt.CompiledProgram(port)
        if call:
            before = port.to_bytes()
            got = shard_program(compiled, pgspmd.MeshPlan(dp=4, tp=2),
                                loss_name=loss, min_size=256)
            assert got is compiled
            assert port.to_bytes() == before
            assert compiled._mesh is None and compiled._sharding_fn is None
        scope = convert.params_from_numpy(start, pt.Scope(), "cpu")
        pexe = pt.Executor(pt.CPUPlace())
        out = [pexe.run(compiled, feed=_feed(s), fetch_list=[loss],
                        scope=scope, return_numpy=False)[0]
               for s in range(STEPS)]
        runs.append((out, {v.name: scope.find_var(v.name).get()
                           for v in port.all_parameters()}))
    (a, pa), (b, pb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(pa[n], pb[n]) for n in pa)


# ---------------------------------------------------------------------------
# the clusters against the JAX sharded step
# ---------------------------------------------------------------------------

def _held(port, jax_run):
    np.testing.assert_allclose(port["losses"], jax_run["losses"],
                               rtol=2e-5, atol=1e-6)
    for s in range(STEPS):
        for gn, a, b in zip(GRADS, port["grads"][s], jax_run["grads"][s]):
            np.testing.assert_allclose(np.asarray(a), b, rtol=5e-4,
                                       atol=5e-6, err_msg=f"step {s} {gn}")
    assert set(port["params"]) == set(jax_run["params"])
    for n, v in jax_run["params"].items():
        np.testing.assert_allclose(np.asarray(port["params"][n]), v,
                                   rtol=5e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("rank", range(4))
def test_dp2_tp2_matches_jax_sharded_step(clusters, rank):
    """shard_program(MeshPlan(dp=2, tp=2)) on 4 gloo ranks: losses, the
    sampled gradients (gathered by the fetch) and every parameter after 3
    steps within the JAX test's bounds of the JAX package's sharded step;
    each rank holds (16, 16) of q.w and of its first moment, (64, 32) of
    the embedding."""
    r = clusters["four"][rank]["dp2tp2"]
    _held(r, clusters["jax"]["dp2tp2"])
    b = r["blocks"]
    assert b["tfm_l0_self_q.w"] == [16, 16]
    moment = next(n for n in b if n.startswith("tfm_l0_self_q.w_moment1"))
    assert b[moment] == [16, 16]
    assert b["tfm_emb.w"] == [64, 32]
    assert b["tfm_l0_ffn_fc2.w"] == [32, 16]       # ("tp", "dp") of 64x32


@pytest.mark.parametrize("rank", range(2))
def test_dp1_tp2_matches_jax_sharded_step(clusters, rank):
    r = clusters["two"][rank]["dp1tp2"]
    _held(r, clusters["jax"]["dp1tp2"])
    assert r["blocks"]["tfm_l0_self_q.w"] == [32, 16]
    assert r["blocks"]["tfm_l0_ffn_fc1.b"] == [32]
    assert "tfm_emb.w" not in r["blocks"]        # dp 1: no ZeRO-3


@pytest.mark.parametrize("rank", range(2))
def test_zero3_spec_matches_zero_sharding_rules(clusters, rank):
    """ZeRO-3 as annotations (shard_program(MeshPlan(dp=2))) trains as
    zero_sharding_rules(stage=3) through with_sharding_rules, each rank
    holding half the weight's rows either way."""
    z = clusters["two"][rank]["zero3"]
    np.testing.assert_allclose(z["gspmd"]["losses"], z["zero"]["losses"],
                               rtol=1e-5)
    assert z["gspmd"]["rows"] == z["zero"]["rows"] == [8, 1]
    assert z["zero"]["whole"] == [16, 1]
    assert z["gspmd"]["losses"][-1] < z["gspmd"]["losses"][0]


@pytest.mark.parametrize("rank", range(4))
def test_head_count_fallback_equals_unsharded(clusters, rank):
    """2 heads on tp 4: q, k and v gathered and the kernel run on every
    head, the step equal to the unsharded one within the JAX test's
    bounds."""
    h = clusters["four"][rank]["heads2"]
    assert h["tags"] == ["tp", "tp"]
    assert all(h["flash_out_whole"])
    assert h["q_block"] == [32, 8]
    np.testing.assert_allclose(h["sharded"]["losses"], h["plain"]["losses"],
                               rtol=2e-5, atol=1e-6)
    for n, v in h["plain"]["params"].items():
        np.testing.assert_allclose(h["sharded"]["params"][n], v, rtol=5e-4,
                                   atol=1e-5, err_msg=n)


def test_hybrid_mesh_and_shard_map_match_jax(clusters):
    """make_hybrid_mesh({"dp": 2}, {"tp": 2}) and shard_map of a function
    with a sum over tp, against the JAX package's on 4 CPU devices."""
    mesh = jenv.make_hybrid_mesh({"dp": 2}, {"tp": 2},
                                 devices=jax.devices()[:4])
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)

    def f(blk):
        return blk * 2 + jax.lax.psum(blk, "tp")

    want = np.asarray(jenv.shard_map(f, mesh, in_specs=JP("dp", "tp"),
                                     out_specs=JP("dp", "tp"))(x))
    for r in clusters["four"]:
        h = r["hybrid"]
        assert tuple(h["axis_names"]) == tuple(mesh.axis_names)
        assert h["shape"] == dict(mesh.shape)
        np.testing.assert_array_equal(np.asarray(h["y"]), want)
