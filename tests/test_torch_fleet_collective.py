"""Fleet's collective mode, the launcher and the collective transpilers
on the port, against the JAX package.

- ``tests/test_fleet.py``'s three collective cases over the port (one
  worker): training converges, ZeRO stage 1 trains, the model saves;
  and ``use_amp`` trains under the AMP decorator.
- The port's ``launch.py`` keeps ``test_launch_spawns_ranked_processes``'s
  contract and passes SIGTERM on to its children.
- A 2-process fleet job through the launcher (gloo, CPU places) matches
  the JAX package's single-process 8-device trajectory at
  ``tests/test_multihost_bootstrap.py``'s bars (rtol 1e-4, atol 1e-6,
  the ranks equal to each other), its sharded fetch global, an uneven
  shard raising "divide".
- ``GradAllReduce`` and ``LocalSGD`` of the port on a program built by
  the JAX package append the JAX transpile's ops (``to_dict`` equal), and
  ``LocalSGD(k_steps=3)`` at world 1 trains bitwise the JAX run of
  ``tests/test_dist_ps.py:518-560``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
from torch_port_helpers import fresh_port_programs, free_port

import paddle_tpu as fluid
from paddle_tpu import framework as jax_framework
from paddle_tpu import layers, optimizer
from paddle_tpu.parallel import env as jenv

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core.program import Program as PortProgram
from paddle_tpu_torch.fleet import (DistributedStrategy,
                                    UserDefinedRoleMaker, fleet)
from paddle_tpu_torch.parallel import env as penv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 240


@pytest.fixture
def port_fleet():
    penv.reset()
    with fresh_port_programs():
        yield fleet
    fleet._compiled = None
    penv.reset()


def _mlp(pkg, width=8):
    L = pkg.layers
    x = L.data("x", shape=[width], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    pred = L.fc(x, size=1)
    return x, y, pred, L.mean(L.square_error_cost(pred, y))


# ---------------------------------------------------------------------------
# tests/test_fleet.py's collective cases, over the port
# ---------------------------------------------------------------------------

def test_fleet_collective_training(port_fleet):
    rng = np.random.RandomState(0)
    W = rng.randn(8, 1).astype(np.float32)
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    assert fleet.is_first_worker() and fleet.worker_num() == 1
    _, _, _, loss = _mlp(pt)
    fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                DistributedStrategy()).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(fleet.startup_program)
    losses = []
    for _ in range(40):
        bx = rng.rand(32, 8).astype(np.float32)
        lv, = exe.run(fleet.main_program,
                      feed={"x": bx, "y": bx @ W}, fetch_list=[loss])
        losses.append(float(lv))
    assert losses[-1] < losses[0] * 0.2, losses[::10]


def test_fleet_zero_strategy(port_fleet):
    rng = np.random.RandomState(1)
    W = rng.randn(8, 1).astype(np.float32)
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    _, _, _, loss = _mlp(pt)
    strategy = DistributedStrategy()
    strategy.zero_stage = 1
    fleet.distributed_optimizer(pt.optimizer.Adam(0.05),
                                strategy).minimize(loss)
    assert fleet.main_program._sharding_fn is not None
    exe = pt.Executor(pt.CPUPlace())
    exe.run(fleet.startup_program)
    for _ in range(10):
        bx = rng.rand(32, 8).astype(np.float32)
        lv, = exe.run(fleet.main_program,
                      feed={"x": bx, "y": bx @ W}, fetch_list=[loss])
    assert np.isfinite(lv)


def test_fleet_use_amp_strategy(port_fleet):
    """strategy.use_amp wraps the optimizer in the AMP decorator (loss
    scaling at amp_loss_scaling) before the data-parallel compile."""
    rng = np.random.RandomState(3)
    W = rng.randn(8, 1).astype(np.float32)
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    L = pt.layers
    x = L.data("x", shape=[8], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(L.fc(L.fc(x, 16, act="relu"), 1), y))
    strategy = DistributedStrategy()
    strategy.use_amp = True
    fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                strategy).minimize(loss)
    types = {op.type for op in pt.default_main_program().global_block().ops}
    assert {"cast", "check_finite_and_unscale",
            "update_loss_scaling"} <= types
    exe = pt.Executor(pt.CPUPlace())
    exe.run(fleet.startup_program)
    losses = []
    for _ in range(20):
        bx = rng.rand(32, 8).astype(np.float32)
        lv, = exe.run(fleet.main_program, feed={"x": bx, "y": bx @ W},
                      fetch_list=[loss])
        losses.append(float(lv))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_fleet_save_inference_model(port_fleet, tmp_path):
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    _, _, pred, loss = _mlp(pt, width=4)
    fleet.distributed_optimizer(pt.optimizer.SGD(0.1)).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(fleet.startup_program)
    d = str(tmp_path / "fleet_model")
    fleet.save_inference_model(exe, d, ["x"], [pred])
    assert os.path.exists(os.path.join(d, "__model__"))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_LAUNCH_CHILD = r"""
import os, sys
tid = os.environ["PADDLE_TRAINER_ID"]
num = os.environ["PADDLE_TRAINERS_NUM"]
eps = os.environ["PADDLE_TRAINER_ENDPOINTS"]
cur = os.environ["PADDLE_CURRENT_ENDPOINT"]
assert eps.split(",")[int(tid)] == cur
assert os.environ["PADDLE_COORDINATOR_ENDPOINT"] == eps.split(",")[0]
assert os.environ["FLAGS_selected_gpus"] == tid
print(f"rank={tid}/{num} ep={cur}")
"""


def _launch(args):
    return [sys.executable, "-m", "paddle_tpu_torch.launch", *args]


def test_launch_spawns_ranked_processes(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_LAUNCH_CHILD)
    out = subprocess.run(
        _launch(["--nproc_per_node", "2", "--started_port",
                 str(free_port()), str(script)]),
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "rank=0/2" in out.stdout
    assert "rank=1/2" in out.stdout


def test_launch_defaults_and_passes_sigterm_on(tmp_path):
    """--nproc_per_node keeps its default of 1, and a SIGTERM to the
    launcher reaches every child, whose own handler runs."""
    child = tmp_path / "sleeper.py"
    child.write_text(textwrap.dedent(f"""
        import os, signal, sys, time
        def bye(sig, frame):
            open(os.path.join({str(tmp_path)!r},
                 "got" + os.environ["PADDLE_TRAINER_ID"]), "w").close()
            sys.exit(0)
        signal.signal(signal.SIGTERM, bye)
        open(os.path.join({str(tmp_path)!r},
             "up" + os.environ["PADDLE_TRAINER_ID"]), "w").close()
        time.sleep(60)
    """))
    one = subprocess.run(_launch(["--started_port", str(free_port()),
                                  str(tmp_path / "no_such_script.py")]),
                         capture_output=True, text=True, timeout=60,
                         cwd=REPO)
    assert one.returncode != 0 and one.stderr.count("no_such_script") == 1
    proc = subprocess.Popen(_launch(["--nproc_per_node", "2",
                                     "--started_port", str(free_port()),
                                     str(child)]), cwd=REPO)
    try:
        t0 = time.time()
        while not all((tmp_path / f"up{r}").exists() for r in range(2)):
            assert time.time() - t0 < 60, "children never came up"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert code == 128 + signal.SIGTERM
    assert (tmp_path / "got0").exists() and (tmp_path / "got1").exists()


# ---------------------------------------------------------------------------
# a 2-process fleet job against the JAX package's 8-device trajectory
# ---------------------------------------------------------------------------

_TRAIN_RUNNER = textwrap.dedent("""
    import json, os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fleet import (DistributedStrategy,
                                        PaddleCloudRoleMaker, fleet)

    fleet.init(PaddleCloudRoleMaker(), place=pt.CPUPlace())
    fleet.init(PaddleCloudRoleMaker(), place=pt.CPUPlace())  # tolerated
    rank = fleet.worker_index()
    L = pt.layers
    np.random.seed(7)                    # identical params everywhere
    x = L.data("x", shape=[4], dtype="float32")
    y = L.data("y", shape=[1], dtype="float32")
    pred = L.fc(x, 1, bias_attr=False)
    loss = L.mean(L.square_error_cost(pred, y))
    fleet.distributed_optimizer(pt.optimizer.SGD(0.1),
                                DistributedStrategy()).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(fleet.startup_program)
    rng = np.random.RandomState(42)      # same batch stream everywhere
    losses = []
    for _ in range(5):
        bx = rng.rand(16, 4).astype(np.float32)
        by = bx.sum(1, keepdims=True)
        lo = rank * 8, (rank + 1) * 8    # my process-local shard
        lv, pv = exe.run(fleet.main_program,
                         feed={"x": bx[lo[0]:lo[1]], "y": by[lo[0]:lo[1]]},
                         fetch_list=[loss, pred])
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    try:
        exe.run(fleet.main_program, feed={"x": bx[:5 + rank],
                                          "y": by[:5 + rank]},
                fetch_list=[loss])
        uneven = "no-error"
    except ValueError as e:
        uneven = "raised" if "divide" in str(e) else str(e)[:80]
    fleet.barrier_worker()
    # one write of the whole line: the ranks share the launcher's stdout
    sys.stdout.write("RESULT " + json.dumps({
        "rank": rank, "losses": losses, "pred": list(pv.shape),
        "uneven": uneven}) + "\\n")
    sys.stdout.flush()
""")


def test_two_process_fleet_job_matches_jax_eight_devices(tmp_path):
    """tests/test_multihost_bootstrap.py:155-241 over the port: the job
    through ``python -m paddle_tpu_torch.launch --nproc_per_node 2``."""
    np.random.seed(7)
    jx = layers.data("x", shape=[4], dtype="float32")
    jy = layers.data("y", shape=[1], dtype="float32")
    jpred = layers.fc(jx, 1, bias_attr=False)
    jloss = layers.mean(layers.square_error_cost(jpred, jy))
    optimizer.SGD(0.1).minimize(jloss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(jax_framework.default_startup_program())
    # the 8 devices given: a current mesh that an earlier test left would
    # be taken instead; the one found is put back after
    prev = jenv.get_mesh()
    compiled = fluid.CompiledProgram(
        jax_framework.default_main_program()).with_data_parallel(
        loss_name=jloss.name, mesh=jenv.make_mesh(devices=jax.devices()[:8]))
    rng = np.random.RandomState(42)
    ref = []
    try:
        for _ in range(5):
            bx = rng.rand(16, 4).astype(np.float32)
            lv, = exe.run(compiled, feed={"x": bx,
                                          "y": bx.sum(1, keepdims=True)},
                          fetch_list=[jloss])
            ref.append(float(np.asarray(lv)))
    finally:
        if prev is None:
            jenv.reset()
        else:
            jenv.set_mesh(prev)

    script = tmp_path / "train.py"
    script.write_text(_TRAIN_RUNNER)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), "OMP_NUM_THREADS": "1"}
    for k in ("PADDLE_PSERVERS_IP_PORT_LIST", "TRAINING_ROLE"):
        env.pop(k, None)
    out = subprocess.run(
        _launch(["--nproc_per_node", "2", "--started_port",
                 str(free_port()), str(script)]),
        capture_output=True, text=True, timeout=JOB_TIMEOUT_S, cwd=REPO,
        env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    results = sorted((json.loads(ln[len("RESULT "):])
                      for ln in out.stdout.splitlines()
                      if ln.startswith("RESULT ")), key=lambda r: r["rank"])
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["uneven"] == "raised" for r in results), results
    assert all(r["pred"] == [16, 1] for r in results)
    np.testing.assert_allclose(results[0]["losses"], results[1]["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(results[0]["losses"], ref, rtol=1e-4,
                               atol=1e-6)
    assert results[0]["losses"][-1] < results[0]["losses"][0]


# ---------------------------------------------------------------------------
# the collective transpilers
# ---------------------------------------------------------------------------

def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _jax_program():
    x = layers.data("x", shape=[4], dtype="float32")
    loss = layers.mean(layers.fc(x, 1))
    optimizer.SGD(0.1).minimize(loss)
    return (jax_framework.default_main_program(),
            jax_framework.default_startup_program(), loss)


@pytest.mark.parametrize("which", ["GradAllReduce", "LocalSGD"])
def test_transpile_of_a_jax_program_equals_jax(which):
    from paddle_tpu import transpiler as jax_transpiler

    main, startup, _ = _jax_program()
    port_main = PortProgram.from_dict(main.to_dict())
    port_start = PortProgram.from_dict(startup.to_dict())
    kw = {"k_steps": 3} if which == "LocalSGD" else {}
    eps = "127.0.0.1:6170,127.0.0.1:6171"
    getattr(jax_transpiler, which)(**kw).transpile(
        startup, main, rank=1, endpoints=eps,
        current_endpoint="127.0.0.1:6171")
    t = getattr(pt.transpiler, which)(**kw).transpile(
        port_start, port_main, rank=1, endpoints=eps,
        current_endpoint="127.0.0.1:6171")
    assert t.nranks == 2
    assert _canon(port_main) == _canon(main)
    assert _canon(port_start) == _canon(startup)
    assert pt.transpiler.LocalSGD.transpile.__wrapped_pass__ == \
        "collective_transpile"


@pytest.mark.parametrize("data", ["dyadic", "jax_test"])
def test_local_sgd_k3_at_world_one_trains_as_jax(data):
    """tests/test_dist_ps.py:518-560: at world 1 the all-reduce is the
    identity and the scale 1.0, so 7 steps train as the JAX run.  On
    dyadic data (inputs on a 1/8 grid, parameters on a 1/16 grid, the
    rate 1/8) every sum is exact, so the packages' reduction orders cannot
    round apart: array_equal.  On the JAX test's own data (rate 0.1,
    uniform inputs, the startup's parameters) they agree to an ulp."""
    from paddle_tpu import transpiler as jax_transpiler
    from paddle_tpu.core.scope import global_scope

    dyadic = data == "dyadic"
    x = layers.data("x", shape=[4], dtype="float32")
    loss = layers.mean(layers.fc(x, 1))
    optimizer.SGD(0.125 if dyadic else 0.1).minimize(loss)
    main = jax_framework.default_main_program()
    startup = jax_framework.default_startup_program()
    port_main = PortProgram.from_dict(main.to_dict())
    port_start = PortProgram.from_dict(startup.to_dict())
    for t, (m, s) in ((jax_transpiler.LocalSGD(k_steps=3), (main, startup)),
                      (pt.transpiler.LocalSGD(k_steps=3),
                       (port_main, port_start))):
        t.transpile(s, m, rank=0, endpoints="a:1", current_endpoint="a:1")
    types = [op.type for op in port_main.global_block().ops]
    assert "increment" in types and "elementwise_mod" in types
    assert types.count("where") == 2 and types.count("c_allreduce_sum") == 2
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    params = [v.name for v in main.all_parameters()]
    rng = np.random.RandomState(0)
    if dyadic:
        for n in params:
            v = np.asarray(global_scope().find_var(n).get())
            global_scope().var(n).set(
                (rng.randint(-16, 17, v.shape) / 16).astype(np.float32))
        feeds = [(rng.randint(0, 9, (8, 4)) / 8).astype(np.float32)
                 for _ in range(7)]
    else:
        feeds = [rng.rand(8, 4).astype(np.float32) for _ in range(7)]
    start = {n: np.asarray(global_scope().find_var(n).get()) for n in params}
    want = [np.asarray(exe.run(main, feed={"x": bx},
                               fetch_list=[loss])[0]) for bx in feeds]
    want_params = {n: np.asarray(global_scope().find_var(n).get())
                   for n in params}
    penv.reset()
    if dyadic:
        def same(a, b):
            np.testing.assert_array_equal(a, b)
    else:
        def same(a, b):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    with fresh_port_programs():
        pexe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        pexe.run(port_start, scope=scope)
        convert.params_from_numpy(start, scope, "cpu")
        got = [pexe.run(port_main, feed={"x": bx}, fetch_list=[loss.name],
                        scope=scope)[0] for bx in feeds]
        step = scope.find_var(pt.transpiler.LocalSGD.STEP_VAR).get()
        for a, b in zip(got, want):
            same(a, b)
        for n in params:
            same(scope.find_var(n).get().numpy(), want_params[n])
        assert int(step.reshape(-1)[0]) == 7
