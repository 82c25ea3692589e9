"""The port's data parallelism against the JAX package's.

The JAX package's ``with_data_parallel`` shards every feed's batch over
the 8 virtual CPU devices of ``tests/conftest.py`` and XLA partitions the
step (batch statistics included).  The port's runs one process a device:
each rank here is a gloo process on a CPU place feeding its half of the
batch.  Programs are built by the JAX package and carried over by
``to_bytes``; parameters come from the JAX package's startup
(``convert.params_from_numpy``).  One spawn of a 2-rank cluster serves a
group of cases.

- ``tests/test_data_parallel.py``'s MLP at that test's tolerance (rtol
  1e-4, atol 1e-5), its sharded fetch of ``pred`` (16, 1), an uneven
  shard raising "divide", the parameters equal on both ranks.
- ResNet-18 on CIFAR shapes at that test's bars (step 0 rtol 1e-4, every
  step rtol 2e-2 and atol 1e-5): global batch-norm statistics.
- ZeRO-1 equal to replicated data parallelism (rtol 1e-5), each rank
  holding half of each large accumulator, outside the scope (whose entry
  refuses a read); AMP with ZeRO-1 equal to AMP with replicated data
  parallelism through an overflow in one rank's rows, the ranks equal;
  any other optimize op reading a sharded gradient refused.
- ``GradAllReduce`` at world 2 equal to one process on the global batch
  (rtol 1e-5).
- The batch statistics' ops in a data-parallel step against the same op
  on the whole batch, and ``sync_batch_norm`` against the JAX op under
  ``shard_map``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu as fluid
from paddle_tpu import layers, optimizer
from paddle_tpu.core.registry import get_op_def as jax_def
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from paddle_tpu.parallel import env as jenv
from torch_port_helpers import fresh_port_programs, run_port_cluster

import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import env as penv

# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _mlp():
    """tests/test_data_parallel.py's net."""
    img = layers.data("img", shape=[32], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    h = layers.fc(img, size=32, act="relu")
    logits = layers.fc(h, size=4)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return loss, logits


def _mlp_batches(n, bs=16):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        x = rng.rand(bs, 32).astype(np.float32)
        y = x[:, :4].argmax(axis=1).astype(np.int64).reshape(bs, 1)
        out.append((x, y))
    return out


def _persistables(main):
    from paddle_tpu.core.scope import global_scope

    return {v.name: np.asarray(global_scope().find_var(v.name).get())
            for v in main.persistables()
            if not v.is_data and global_scope().find_var(v.name) is not None
            and global_scope().find_var(v.name).get() is not None}


def _jax_dp(main, startup, loss_name, seed, batches, fetch=None):
    """The JAX package's 8-device data-parallel run from a startup seeded
    ``seed``: (the start's persistables, losses, last fetch).  The mesh is
    given: ``with_data_parallel`` would take a current mesh that an
    earlier test in the process left (one device gives another
    trajectory), and the one found is put back after."""
    exe = fluid.Executor(fluid.CPUPlace())
    prev = jenv.get_mesh()
    try:
        with jax_scope_guard(JaxScope()):
            np.random.seed(seed)
            exe.run(startup)
            start = _persistables(main)
            dp = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss_name,
                mesh=jenv.make_mesh(devices=jax.devices()[:8]))
            losses, last = [], None
            for feed in batches:
                out = exe.run(dp, feed=feed, fetch_list=[loss_name]
                              + ([fetch] if fetch else []))
                losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
                last = out[1:]
    finally:
        if prev is None:
            jenv.reset()
        else:
            jenv.set_mesh(prev)
    return start, losses, last


def _write(tmp_path, name, main, startup, start):
    d = tmp_path / name
    d.mkdir()
    (d / "main.json").write_bytes(main.to_bytes())
    (d / "startup.json").write_bytes(startup.to_bytes())
    np.savez(d / "start.npz", **start)
    return str(d)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

_PRELUDE = r"""
import json, os
import numpy as np, torch
torch.set_num_threads(1)
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.parallel import env as penv

args = json.loads(os.environ["PT_CLUSTER_ARGS"])
rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
penv.init_parallel_env(rank, world, os.environ["PADDLE_COORDINATOR_ENDPOINT"],
                       place=pt.CPUPlace())
mesh = penv.set_mesh(penv.make_mesh())
group = mesh.group("dp")
exe = pt.Executor(pt.CPUPlace())
out = {"backend": penv.backend(), "rank": rank}


def load(d):
    main = pt.Program.parse_from_bytes(open(os.path.join(d, "main.json"),
                                            "rb").read())
    startup = pt.Program.parse_from_bytes(
        open(os.path.join(d, "startup.json"), "rb").read())
    scope = pt.Scope()
    convert.params_from_numpy(dict(np.load(os.path.join(d, "start.npz"))),
                              scope, "cpu")
    return main, startup, scope


def mine(a):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def same_across(tensors):
    bad = []
    for name, t in tensors.items():
        got = penv.collective("all_gather", t, group, world)
        if not all(torch.equal(got[0], g) for g in got[1:]):
            bad.append(name)
    return bad


def lst(t):
    return np.asarray(t, dtype=np.float64).tolist()
"""

_MLP_SCRIPT = _PRELUDE + r"""
rng_batches = np.load(os.path.join(args["mlp"], "batches.npz"))
main, startup, scope = load(args["mlp"])
loss = args["mlp_loss"]
dp = pt.CompiledProgram(main).with_data_parallel(loss_name=loss)
losses = []
for i in range(rng_batches["x"].shape[0]):
    lv, pred = exe.run(dp, feed={"img": mine(rng_batches["x"][i]),
                                 "label": mine(rng_batches["y"][i])},
                       fetch_list=[loss, args["mlp_pred"]], scope=scope)
    losses.append(float(np.asarray(lv).reshape(-1)[0]))
out["mlp_losses"] = losses
out["pred_shape"] = list(pred.shape)
params = {v.name: scope.find_var(v.name).get() for v in main.all_parameters()}
out["params_differing"] = same_across(params)
try:
    n = 5 + rank
    exe.run(dp, feed={"img": rng_batches["x"][0][:n],
                      "label": rng_batches["y"][0][:n]},
            fetch_list=[loss], scope=scope)
    out["uneven"] = "no-error"
except ValueError as e:
    out["uneven"] = "raised" if "divide" in str(e) else str(e)[:120]
try:
    exe.run(dp, feed={"img": mine(rng_batches["x"][0]),
                      "label": mine(rng_batches["y"][0])},
            fetch_list=[args["mlp_hidden_mean"]], scope=scope)
    out["other_fetch"] = "no-error"
except ValueError as e:
    out["other_fetch"] = type(e).__name__

# ZeRO-1 against replicated data parallelism, on a net whose first
# weight's moments pass zero_sharding_rules' min_size
from paddle_tpu_torch.parallel.zero import zero_sharding_rules
L = pt.layers
zmain, zstart = pt.Program(), pt.Program()
with pt.program_guard(zmain, zstart), pt.unique_name.guard():
    x = L.data("x", shape=[32], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    zpred = L.fc(L.fc(x, 256, act="relu"), 1)
    zloss = L.mean(L.square_error_cost(zpred, y))
    pt.optimizer.Adam(0.01).minimize(zloss)
zr = np.random.RandomState(5)
zfeeds = [(zr.rand(16, 32).astype(np.float32),) for _ in range(4)]
zfeeds = [(bx, bx[:, :3].sum(1, keepdims=True)) for (bx,) in zfeeds]
zruns = {}
for zero in (0, 1):
    sc = pt.Scope()
    np.random.seed(11)
    exe.run(zstart, scope=sc)
    prog = pt.CompiledProgram(zmain).with_data_parallel(
        loss_name=zloss.name)
    if zero:
        prog = prog.with_sharding_rules(zero_sharding_rules(
            stage=zero, program=zmain))
    moments = sorted(v.name for v in zmain.persistables()
                     if "moment" in v.name)
    zl = []
    for bx, by in zfeeds:
        got = exe.run(prog, feed={"x": mine(bx), "y": mine(by)},
                      fetch_list=[zloss] + moments, scope=sc)
        zl.append(float(got[0]))
    rows = prog.sharded_state()
    acc = {n: list((rows[n] if n in rows else sc.find_var(n).get()).shape)
           for n in moments}
    try:
        sc.find_var(max(moments, key=lambda n: np.prod(acc[n]))).get()
        scope_read = "no-error"
    except RuntimeError as e:
        scope_read = type(e).__name__
    zruns[zero] = {"losses": zl, "accumulators": acc, "params": {
        v.name: lst(sc.find_var(v.name).get()) for v in
        zmain.all_parameters()}, "fetched_moments": {
        n: lst(v) for n, v in zip(moments, got[1:])},
        "scope_read": scope_read}
out["zero"] = zruns

# AMP with ZeRO-1 against AMP with replicated data parallelism.  The
# plant adds g * W to the loss: g is 1e36 at W's row 20 (rank 1's rows)
# on rank 1's first two steps, where W is set to 1e-36, so the term is 1
# but W's gradient under the loss scale overflows there alone.  Every
# rank must skip those updates and lower its loss scaling alike.
from paddle_tpu_torch.contrib import mixed_precision as amp
amp_runs = {}
for zero in (0, 1):
    amain, astart = pt.Program(), pt.Program()
    with pt.program_guard(amain, astart), pt.unique_name.guard():
        x = L.data("x", shape=[32], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        g = L.data("g", shape=[32, 256], dtype="float32",
                   append_batch_size=False)
        h = L.fc(x, 256, act="relu")
        w = amain.all_parameters()[0]
        aloss = L.elementwise_add(
            L.mean(L.square_error_cost(L.fc(h, 1), y)),
            L.reduce_sum(L.elementwise_mul(w, g)))
        aopt = amp.decorate(pt.optimizer.Adam(0.01))
        aopt.minimize(aloss)
    sc = pt.Scope()
    np.random.seed(17)
    exe.run(astart, scope=sc)
    wv = sc.find_var(w.name).get()
    wv[20, 0] = 1e-36
    prog = pt.CompiledProgram(amain).with_data_parallel(
        loss_name=aloss.name)
    if zero:
        prog = prog.with_sharding_rules(zero_sharding_rules(
            stage=zero, program=amain))
    al = []
    for i, (bx, by) in enumerate(zfeeds):
        gv = np.zeros((32, 256), np.float32)
        if i < 2 and rank == 1:
            gv[20, 0] = 1e36
        al.append(float(exe.run(prog, feed={"x": mine(bx), "y": mine(by),
                                            "g": gv},
                                fetch_list=[aloss], scope=sc)[0]))
    scaling = {k: sc.find_var(v.name).get() for k, v in (
        ("scale", aopt._loss_scaling), ("good", aopt._good_steps),
        ("bad", aopt._bad_steps))}
    aparams = {v.name: sc.find_var(v.name).get()
               for v in amain.all_parameters()}
    amp_runs[zero] = {
        "losses": al, "sharded": sorted(prog.sharded_state()),
        "params": {n: lst(v) for n, v in aparams.items()},
        "scaling": {n: lst(v) for n, v in scaling.items()},
        "differing_across_ranks": same_across({**aparams, **scaling})}
out["amp_zero"] = amp_runs

# any other optimize op that reads a sharded gradient is refused
rmain, rstart = pt.Program(), pt.Program()
with pt.program_guard(rmain, rstart), pt.unique_name.guard():
    x = L.data("x", shape=[32], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    rloss = L.mean(L.square_error_cost(L.fc(L.fc(x, 256, act="relu"), 1),
                                       y))
    pt.optimizer.Adam(0.01).minimize(rloss)
    blk = rmain.global_block()
    wg = rmain.all_parameters()[0].name + "@GRAD"
    blk.append_op(type="scale", inputs={"X": wg},
                  outputs={"Out": blk.create_var(name="wg_seen",
                                                 dtype="float32")},
                  attrs={"scale": 1.0}, op_role="optimize")
sc = pt.Scope()
exe.run(rstart, scope=sc)
prog = pt.CompiledProgram(rmain).with_data_parallel(
    loss_name=rloss.name).with_sharding_rules(zero_sharding_rules(
        stage=1, program=rmain))
try:
    exe.run(prog, feed={"x": mine(zfeeds[0][0]), "y": mine(zfeeds[0][1])},
            fetch_list=[rloss], scope=sc)
    out["zero_stray_reader"] = "no-error"
except NotImplementedError as e:
    out["zero_stray_reader"] = str(e)

# GradAllReduce at world 2 against one process on the global batch
gmain, gstart = pt.Program(), pt.Program()
with pt.program_guard(gmain, gstart), pt.unique_name.guard():
    x = L.data("x", shape=[32], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    gloss = L.mean(L.square_error_cost(L.fc(L.fc(x, 16, act="relu"), 1), y))
    pt.optimizer.SGD(0.1).minimize(gloss)
eps = os.environ["PADDLE_TRAINER_ENDPOINTS"]
pt.transpiler.GradAllReduce().transpile(
    gstart, gmain, rank, eps, os.environ["PADDLE_CURRENT_ENDPOINT"])
gsc = pt.Scope()
np.random.seed(13)
exe.run(gstart, scope=gsc)
gl = []
for bx, by in zfeeds:
    lv, = exe.run(gmain, feed={"x": mine(bx), "y": mine(by)},
                  fetch_list=[gloss], scope=gsc)
    gl.append(float(np.asarray(lv).reshape(-1)[0]))
out["grad_allreduce"] = {"local_losses": gl, "params": {
    v.name: lst(gsc.find_var(v.name).get()) for v in gmain.all_parameters()}}

# the batch statistics' ops in a data-parallel step against the whole
# batch on one rank (rank 0 compares)
cpu = torch.device("cpu")
br = np.random.RandomState(21)
def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))
x4 = t(br.standard_normal((8, 6, 5, 5)) * 2 + 1)
dy4 = t(br.standard_normal((8, 6, 5, 5)))
bn_in = {"X": x4, "Scale": t(br.uniform(0.5, 1.5, 6)),
         "Bias": t(br.uniform(-0.5, 0.5, 6)), "Mean": t(np.zeros(6)),
         "Variance": t(np.ones(6))}
bn_attrs = get_op_def("batch_norm").canonical_attrs({})
xn = x4.permute(0, 2, 3, 1).contiguous()
w = t(br.standard_normal((4, 6, 3, 3)) * 0.3)
cb_in = {"Input": xn, "Filter": w, "Scale": t(br.uniform(0.5, 1.5, 4)),
         "BNBias": t(br.uniform(-0.5, 0.5, 4)), "Mean": t(np.zeros(4)),
         "Variance": t(np.ones(4))}
cb_dy = t(br.standard_normal((8, 5, 5, 4)))
cb_attrs = get_op_def("conv2d_bn_train").canonical_attrs(
    {"paddings": [1, 1], "act": "relu", "data_format": "NHWC"})

def run_pair(op, ins, dy, attrs, batch_slot, out_slot, grads):
    fwd, bwd = get_op_def(op), get_op_def(op + "_grad")
    def run(ins, dy):
        o = fwd.compute(ins, attrs, cpu)
        g = bwd.compute({**ins, out_slot + "@GRAD": dy}, attrs, cpu)
        return o, g
    whole = run(ins, dy)
    with penv.data_parallel(mesh, "dp"):
        o, g = run({**ins, batch_slot: mine(ins[batch_slot])}, mine(dy))
    got = {out_slot: penv.collective("all_gather", o[out_slot], group,
                                     world).reshape(whole[0][out_slot].shape),
           "SavedMean": o["SavedMean"], "SavedVariance": o["SavedVariance"],
           "MeanOut": o["MeanOut"], "VarianceOut": o["VarianceOut"],
           batch_slot + "@GRAD": penv.collective(
               "all_gather", g[batch_slot + "@GRAD"], group, world).reshape(
               ins[batch_slot].shape),
           **{k: penv.collective("all_reduce", g[k], group, world)
              for k in grads}}
    want = {**whole[0], **whole[1]}
    return {k: float((got[k] - want[k]).abs().max()
                     / max(1.0, float(want[k].abs().max()))) for k in got}

from paddle_tpu_torch.flags import set_flags
out["bn"] = {"batch_norm": run_pair("batch_norm", bn_in, dy4, bn_attrs, "X",
                                    "Y", ("Scale@GRAD", "Bias@GRAD"))}
for mode in ("interpret", "off"):
    set_flags({"conv_bn_stats": mode})
    out["bn"]["conv2d_bn_train_" + mode] = run_pair(
        "conv2d_bn_train", cb_in, cb_dy, cb_attrs, "Input", "Output",
        ("Filter@GRAD", "Scale@GRAD", "BNBias@GRAD"))
set_flags({"conv_bn_stats": "off"})

# sync_batch_norm over the mesh's axis (JAX: under shard_map)
sb = get_op_def("sync_batch_norm")
sbo = sb.compute({**bn_in, "X": mine(x4)}, sb.canonical_attrs({}), cpu)
out["sync_bn"] = {k: lst(v) for k, v in sbo.items()}
out["routes"] = penv.routes()
penv.shutdown()
print("RESULT " + json.dumps(out))
"""

_RESNET_SCRIPT = _PRELUDE + r"""
batches = np.load(os.path.join(args["resnet"], "batches.npz"))
main, startup, scope = load(args["resnet"])
loss = args["resnet_loss"]
dp = pt.CompiledProgram(main).with_data_parallel(loss_name=loss)
losses = []
for i in range(batches["x"].shape[0]):
    lv, = exe.run(dp, feed={"image": mine(batches["x"][i]),
                            "label": mine(batches["y"][i])},
                  fetch_list=[loss], scope=scope)
    losses.append(float(np.asarray(lv).reshape(-1)[0]))
out["losses"] = losses
stats = {n: scope.find_var(n).get() for op in main.global_block().ops
         if op.type == "batch_norm" for n in op.inputs["Mean"]
         + op.inputs["Variance"]}
out["stats"] = len(stats)
out["stats_differing"] = same_across(stats)
penv.shutdown()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def mlp_cluster(tmp_path_factory):
    """The JAX package's MLP run on 8 devices, and one spawn of the
    port's 2-rank cluster for the MLP group of cases."""
    tmp = tmp_path_factory.mktemp("dp_mlp")
    with _fresh_jax():
        loss, logits = _mlp()
        optimizer.SGD(0.1).minimize(loss)
        main = fluid.default_main_program()
        startup = fluid.default_startup_program()
        hidden_mean = layers.mean(main.global_block().var(
            main.global_block().ops[1].outputs["Out"][0]))
        batches = _mlp_batches(6)
        feeds = [{"img": x, "label": y} for x, y in batches]
        start, losses, last = _jax_dp(main, startup, loss.name, 3, feeds,
                                      fetch=logits.name)
        d = _write(tmp, "mlp", main, startup, start)
    np.savez(os.path.join(d, "batches.npz"),
             x=np.stack([x for x, _ in batches]),
             y=np.stack([y for _, y in batches]))
    results = run_port_cluster(_MLP_SCRIPT, 2, {
        "mlp": d, "mlp_loss": loss.name, "mlp_pred": logits.name,
        "mlp_hidden_mean": hidden_mean.name}, timeout=300)
    return {"jax_losses": losses, "jax_pred": last[0], "ranks": results,
            "feeds": feeds}


class _fresh_jax:
    """Fresh default programs of the JAX package (conftest's fixture
    does this per test; a module fixture needs its own)."""

    def __enter__(self):
        from paddle_tpu import framework, unique_name
        from paddle_tpu.core.program import Program

        self._old = (framework.switch_main_program(Program()),
                     framework.switch_startup_program(Program()),
                     unique_name.switch({}))

    def __exit__(self, *exc):
        from paddle_tpu import framework, unique_name

        framework.switch_main_program(self._old[0])
        framework.switch_startup_program(self._old[1])
        unique_name.switch(self._old[2])


def test_dp_mlp_matches_jax_eight_device_dp(mlp_cluster):
    r0, r1 = mlp_cluster["ranks"]
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["mlp_losses"] == r1["mlp_losses"]
    np.testing.assert_allclose(r0["mlp_losses"], mlp_cluster["jax_losses"],
                               rtol=1e-4, atol=1e-5)
    assert r0["mlp_losses"][-1] < r0["mlp_losses"][0]


def test_dp_fetches_uneven_shards_and_replicas(mlp_cluster):
    """The sharded fetch comes back global, an uneven shard raises
    "divide", a fetch the port cannot make global raises, and the
    parameters are equal on both ranks."""
    for r in mlp_cluster["ranks"]:
        assert r["pred_shape"] == [16, 4]
        assert r["uneven"] == "raised"
        assert r["other_fetch"] == "DataParallelFetchError"
        assert r["params_differing"] == []
    assert np.asarray(mlp_cluster["jax_pred"]).shape == (16, 4)


def test_zero1_equals_replicated_dp(mlp_cluster):
    for r in mlp_cluster["ranks"]:
        plain, zero = r["zero"]["0"], r["zero"]["1"]
        np.testing.assert_allclose(zero["losses"], plain["losses"],
                                   rtol=1e-5)
        for n, v in plain["params"].items():
            np.testing.assert_allclose(zero["params"][n], v, rtol=1e-5,
                                       atol=1e-7)
        for n, shape in plain["accumulators"].items():
            if int(np.prod(shape)) >= 2 ** 12:
                assert zero["accumulators"][n] == [shape[0] // 2] \
                    + shape[1:], n
            else:
                assert zero["accumulators"][n] == shape, n
        assert any(int(np.prod(s)) >= 2 ** 12
                   for s in plain["accumulators"].values())


def test_zero1_state_stays_out_of_the_scope(mlp_cluster):
    """Under ZeRO the scope's entry of a sharded accumulator refuses a
    read (no rank holds the whole value), and a fetch of it through the
    compiled program gathers the rows: equal to replicated data
    parallelism's."""
    for r in mlp_cluster["ranks"]:
        plain, zero = r["zero"]["0"], r["zero"]["1"]
        assert plain["scope_read"] == "no-error"
        assert zero["scope_read"] == "ZeroShardedError"
        assert zero["fetched_moments"].keys() == plain["fetched_moments"].keys()
        for n, v in plain["fetched_moments"].items():
            np.testing.assert_allclose(zero["fetched_moments"][n], v,
                                       rtol=1e-5, atol=1e-7)


def test_amp_with_zero1_keeps_the_ranks_together(mlp_cluster):
    """An overflow in one rank's rows of a ZeRO-sharded gradient: AMP's
    flag is global, so the parameters and the loss scaling stay equal
    across the ranks and equal to replicated data parallelism's."""
    for r in mlp_cluster["ranks"]:
        plain, zero = r["amp_zero"]["0"], r["amp_zero"]["1"]
        assert plain["sharded"] == [] and zero["sharded"], zero["sharded"]
        assert plain["differing_across_ranks"] == []
        assert zero["differing_across_ranks"] == []
        np.testing.assert_allclose(zero["losses"], plain["losses"],
                                   rtol=1e-5)
        for n, v in plain["params"].items():
            np.testing.assert_allclose(zero["params"][n], v, rtol=1e-5,
                                       atol=1e-7)
        assert zero["scaling"] == plain["scaling"]
        # two overflowing steps lowered the scale once (decr_ratio 0.8),
        # two clean ones followed
        assert plain["scaling"] == {"scale": [float(np.float32(
            2.0 ** 15 * np.float32(0.8)))], "good": [2], "bad": [0]}


def test_zero_refuses_other_readers_of_sharded_gradients(mlp_cluster):
    """An optimize op other than the parameter's update (or AMP's check)
    that reads a sharded gradient would see one rank's rows: refused,
    naming the gspmd item."""
    for r in mlp_cluster["ranks"]:
        msg = r["zero_stray_reader"]
        assert "'scale' reads the ZeRO-sharded gradients" in msg, msg
        assert "gspmd" in msg


def test_grad_allreduce_transpiled_equals_one_process(mlp_cluster):
    """The transpiled program at world 2 (each rank its half, Executor.run)
    against the same program untranspiled on the global batch."""
    with fresh_port_programs():
        L = pt.layers
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            x = L.data("x", shape=[32], dtype="float32")
            y = L.data("y", shape=[1], dtype="float32")
            loss = L.mean(L.square_error_cost(
                L.fc(L.fc(x, 16, act="relu"), 1), y))
            pt.optimizer.SGD(0.1).minimize(loss)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        np.random.seed(13)
        exe.run(startup, scope=scope)
        zr = np.random.RandomState(5)
        feeds = [zr.rand(16, 32).astype(np.float32) for _ in range(4)]
        losses = [float(exe.run(main, feed={
            "x": bx, "y": bx[:, :3].sum(1, keepdims=True)},
            fetch_list=[loss], scope=scope)[0]) for bx in feeds]
        want = {v.name: scope.find_var(v.name).get().numpy()
                for v in main.all_parameters()}
    r0, r1 = (r["grad_allreduce"] for r in mlp_cluster["ranks"])
    np.testing.assert_allclose(
        (np.asarray(r0["local_losses"]) + r1["local_losses"]) / 2, losses,
        rtol=1e-5)
    for n, v in want.items():
        np.testing.assert_allclose(r0["params"][n], v, rtol=1e-5,
                                   atol=1e-7)
        assert r0["params"][n] == r1["params"][n]


@pytest.mark.parametrize("op", ["batch_norm", "conv2d_bn_train_interpret",
                                "conv2d_bn_train_off"])
def test_batch_statistics_are_global_in_a_dp_step(mlp_cluster, op):
    """Forward and grad of each batch-statistics op over two ranks' halves
    against the op on the whole batch (scaled error)."""
    errs = mlp_cluster["ranks"][0]["bn"][op]
    assert max(errs.values()) < 1e-5, errs


def test_sync_batch_norm_equals_jax_under_shard_map(mlp_cluster):
    br = np.random.RandomState(21)
    x = (br.standard_normal((8, 6, 5, 5)) * 2 + 1).astype(np.float32)
    br.standard_normal((8, 6, 5, 5))
    scale = br.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = br.uniform(-0.5, 0.5, 6).astype(np.float32)
    d = jax_def("sync_batch_norm")
    attrs = d.canonical_attrs({})
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))

    def f(xb):
        o = d.compute({"X": xb, "Scale": jnp.asarray(scale),
                       "Bias": jnp.asarray(bias), "Mean": jnp.zeros(6),
                       "Variance": jnp.ones(6)}, attrs)
        return o["Y"], o["SavedMean"][None], o["SavedVariance"][None]

    y, sm, sv = jenv.shard_map(f, mesh, in_specs=JP("dp"),
                               out_specs=(JP("dp"), JP("dp"), JP("dp")))(x)
    for rank, r in enumerate(mlp_cluster["ranks"]):
        got = r["sync_bn"]
        np.testing.assert_allclose(got["Y"], np.asarray(y)[4 * rank:
                                                           4 * rank + 4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["SavedMean"], np.asarray(sm)[rank],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["SavedVariance"],
                                   np.asarray(sv)[rank], rtol=1e-5)


def test_dp_resnet18_trajectory_matches_jax_eight_device_dp(tmp_path):
    """tests/test_data_parallel.py's ResNet-18/CIFAR trajectory, 2 port
    ranks against the JAX package's 8 devices, at that test's bars: the
    batch statistics are the global batch's (the running statistics
    equal on both ranks)."""
    from paddle_tpu.models.resnet import resnet

    rng = np.random.RandomState(0)
    batches = [(rng.rand(16, 3, 32, 32).astype(np.float32),
                rng.randint(0, 10, (16, 1)).astype(np.int64))
               for _ in range(4)]
    np.random.seed(1234)
    model = resnet(depth=18, num_classes=10, image_shape=(3, 32, 32))
    optimizer.Momentum(learning_rate=0.003, momentum=0.9).minimize(
        model["loss"])
    main = fluid.default_main_program()
    startup = fluid.default_startup_program()
    start, jax_losses, _ = _jax_dp(
        main, startup, model["loss"].name, 1234,
        [{"image": bi, "label": bl} for bi, bl in batches])
    d = _write(tmp_path, "resnet", main, startup, start)
    np.savez(os.path.join(d, "batches.npz"),
             x=np.stack([b for b, _ in batches]),
             y=np.stack([b for _, b in batches]))
    r0, r1 = run_port_cluster(_RESNET_SCRIPT, 2, {
        "resnet": d, "resnet_loss": model["loss"].name}, timeout=400)
    assert r0["losses"] == r1["losses"]
    assert r0["stats"] > 0 and r0["stats_differing"] == []
    np.testing.assert_allclose(r0["losses"][0], jax_losses[0], rtol=1e-4)
    np.testing.assert_allclose(r0["losses"], jax_losses, rtol=2e-2,
                               atol=1e-5)
    assert r0["losses"][-1] < r0["losses"][0]


def test_dp_on_one_process_runs_the_plain_program():
    """No process group: with_data_parallel is the plain compiled program,
    bitwise; more places than the world raise naming the launcher."""
    with fresh_port_programs():
        L = pt.layers
        x = L.data("x", shape=[8], dtype="float32")
        y = L.data("y", shape=[1], dtype="float32")
        pred = L.fc(x, 1)
        loss = L.mean(L.square_error_cost(pred, y))
        pt.optimizer.SGD(0.1).minimize(loss)
        main = pt.default_main_program()
        exe = pt.Executor(pt.CPUPlace())
        bx = np.random.RandomState(1).rand(4, 8).astype(np.float32)
        runs = []
        penv.reset()
        for dp in (False, True):
            scope = pt.Scope()
            np.random.seed(2)
            exe.run(pt.default_startup_program(), scope=scope)
            prog = pt.CompiledProgram(main)
            if dp:
                prog = prog.with_data_parallel(loss_name=loss.name)
                assert penv.get_mesh().shape == {"dp": 1}
            runs.append([exe.run(prog, feed={"x": bx, "y": bx[:, :1]},
                                 fetch_list=[loss, pred], scope=scope)
                         for _ in range(3)])
        penv.reset()
        for a, b in zip(*runs):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        with pytest.raises(NotImplementedError,
                           match="paddle_tpu_torch.launch"):
            pt.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, places=[pt.CPUPlace(), pt.CPUPlace()])
        penv.reset()
