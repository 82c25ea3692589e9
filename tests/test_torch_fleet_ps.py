"""Fleet's parameter-server mode on the port.

- ``PaddleCloudRoleMaker`` and ``UserDefinedRoleMaker`` read the env and
  their arguments as the JAX package's do.
- The PS-mode cluster of ``tests/test_dist_ps.py:409`` (2 pservers from
  ``fleet.init_server`` / ``run_server``, 2 trainers on
  ``fleet.startup_program`` / ``main_program``, subprocesses at a tiny
  width) converges; a second one runs Downpour on a tiny DeepFM through
  ``train_from_dataset``, whose transpile comes from fleet's role
  contract, over MultiSlot files, and converges under the JAX test's
  bar.
- ``init_server(model_dir)`` warm-starts a server's shards from the files
  a ``checkpoint_notify`` wrote.
- The collective mode's single-worker contract (its multi-worker runs
  are ``tests/test_torch_fleet_collective.py``); ``DownpourRunner``,
  fleet's servers, ``AsyncExecutor`` and ``DeviceFeeder`` default to the
  card and refuse to run without one.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER_TIMEOUT_S = 240

_RUNNER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch; torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.fleet import fleet, DistributedStrategy
    from paddle_tpu_torch.fleet.role_maker import PaddleCloudRoleMaker
    from paddle_tpu_torch.distributed.rpc import global_rpc_client

    mode = os.environ["PADDLE_TEST_MODE"]
    fleet.init(PaddleCloudRoleMaker(is_collective=False))
    strategy = DistributedStrategy()
    strategy.mode = "pserver"
    if mode == "fc":
        x = fluid.layers.data("x", shape=[8], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=1), y))
        opt = fleet.distributed_optimizer(fluid.optimizer.SGD(0.05),
                                          strategy)
    else:
        from paddle_tpu_torch.models.deepfm import deepfm_model
        model = deepfm_model(num_fields=4, vocab_size=64, embed_dim=4,
                             dense_dim=3, hidden=(16,), is_sparse=False,
                             is_distributed=True)
        loss = model["loss"]
        strategy.sync_mode = False
        opt = fleet.distributed_optimizer(fluid.optimizer.SGD(0.5),
                                          strategy)
    opt.minimize(loss)
    place = fluid.CPUPlace()
    exe = fluid.Executor(place)
    if fleet.is_server():
        fleet.init_server(place=place)
        fleet.run_server(place=place)
        sys.exit(0)
    np.random.seed(3)
    exe.run(fleet.startup_program)
    losses = []
    if mode == "fc":
        rng = np.random.RandomState(fleet.worker_index())
        W = np.ones((8, 1), np.float32)
        for _ in range(20):
            bx = rng.rand(16, 8).astype(np.float32)
            lv, = exe.run(fleet.main_program, feed={"x": bx, "y": bx @ W},
                          fetch_list=[loss])
            losses.append(float(lv))
    else:
        main = fluid.default_main_program()
        main._fleet_opt = {"trainer": "DistMultiTrainer",
                           "device_worker": "DownpourSGD",
                           "push_window": 3, "pull_dense_every": 2}
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(64)
        ds.set_filelist([os.environ["PADDLE_TEST_FILE"]])
        ds.set_use_var([model["sparse_ids"], model["dense_x"],
                        model["label"]])
        run = exe.run

        def recording(*a, **k):
            out = run(*a, **k)
            losses.append(float(out[0]))
            return out

        exe.run = recording
        exe.train_from_dataset(main, ds, fetch_list=[loss])
        main._fleet_opt["downpour_runner"].finish()
    c = global_rpc_client()
    for ep in fleet.server_endpoints():
        c.send_complete(ep, peer_id="trainer%d" % fleet.worker_index())
    print("LOSSES " + json.dumps(losses))
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_ctr_file(path, trainer_id, batches=80):
    truth = np.arange(64, dtype=np.float32) % 5 - 2.0
    rng = np.random.RandomState(100 + trainer_id)
    with open(path, "w") as f:
        for _ in range(batches * 64):
            ids = rng.randint(0, 64, 4)
            x = rng.rand(3)
            f.write("4 " + " ".join(map(str, ids)) + " 3 "
                    + " ".join(f"{v:.6f}" for v in x)
                    + f" 1 {int(truth[ids].sum() > 0)}\n")


def _run_fleet_cluster(mode, tmp):
    eps = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
    env_base = {**os.environ, "PADDLE_TRAINERS_NUM": "2",
                "PADDLE_PSERVERS_IP_PORT_LIST": eps, "PADDLE_TEST_MODE": mode,
                "CUDA_VISIBLE_DEVICES": "",
                "PYTHONPATH": REPO + os.pathsep
                + os.environ.get("PYTHONPATH", "")}
    procs, trainers = [], []
    for ep in eps.split(","):
        env = {**env_base, "TRAINING_ROLE": "PSERVER",
               "PADDLE_CURRENT_ENDPOINT": ep}
        procs.append(subprocess.Popen([sys.executable, "-c", _RUNNER],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    for tid in range(2):
        path = os.path.join(tmp, f"{mode}-{tid}.txt")
        _write_ctr_file(path, tid)
        env = {**env_base, "TRAINING_ROLE": "TRAINER",
               "PADDLE_TRAINER_ID": str(tid), "PADDLE_TEST_FILE": path}
        trainers.append(subprocess.Popen([sys.executable, "-c", _RUNNER],
                                         env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE))
    losses = []
    try:
        for p in trainers:
            out, err = p.communicate(timeout=CLUSTER_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
            line = [ln for ln in out.decode().splitlines()
                    if ln.startswith("LOSSES ")]
            losses.append(json.loads(line[0][len("LOSSES "):]))
        for p in procs:
            _, err = p.communicate(timeout=CLUSTER_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs + trainers:
            if p.poll() is None:
                p.kill()
                p.wait()
    return losses


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("fleet_clusters"))
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    futs = {m: pool.submit(_run_fleet_cluster, m, tmp)
            for m in ("fc", "downpour")}
    try:
        yield futs
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def test_fleet_ps_mode_cluster(clusters):
    losses = clusters["fc"].result(timeout=2 * CLUSTER_TIMEOUT_S)
    assert len(losses) == 2
    for tl in losses:
        assert len(tl) == 20 and tl[-1] < tl[0] * 0.7, tl[::5]


def test_downpour_through_fleet_role_contract_converges(clusters):
    losses = clusters["downpour"].result(timeout=2 * CLUSTER_TIMEOUT_S)
    assert len(losses) == 2
    for tl in losses:
        assert len(tl) == 80
        assert np.mean(tl[-5:]) < tl[0] * 0.6, tl[::8]


# ---------------------------------------------------------------------------
# role makers, the server's warm start, refusals
# ---------------------------------------------------------------------------

_ENVS = [
    {},
    {"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "3",
     "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2,c:3", "TRAINING_ROLE": "TRAINER",
     "PADDLE_PSERVERS_IP_PORT_LIST": "p:1,p:2"},
    {"TRAINING_ROLE": "PSERVER", "PADDLE_CURRENT_ENDPOINT": "p:2",
     "PADDLE_PSERVERS_IP_PORT_LIST": "p:1,p:2", "PADDLE_TRAINERS_NUM": "2"},
]


def _role(mod, env, monkeypatch):
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
              "TRAINING_ROLE", "PADDLE_PSERVERS_IP_PORT_LIST"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rm = mod.PaddleCloudRoleMaker(is_collective=False)
    rm.generate_role()
    ud = mod.UserDefinedRoleMaker(current_id=1, role=mod.Role.SERVER,
                                  worker_num=2, server_endpoints=["s:1"],
                                  worker_endpoints=["w:0", "w:1"])
    return [(r.is_worker(), r.is_server(), r.is_first_worker(),
             r.worker_index(), r.worker_num(), r.get_trainer_endpoints(),
             r.get_current_endpoint(), r.get_pserver_endpoints())
            for r in (rm, ud)]


@pytest.mark.parametrize("env", range(len(_ENVS)))
def test_role_makers_read_the_env_like_jax(env, monkeypatch):
    from paddle_tpu.fleet import role_maker as jax_rm

    from paddle_tpu_torch.fleet import role_maker

    assert _role(role_maker, _ENVS[env], monkeypatch) == \
        _role(jax_rm, _ENVS[env], monkeypatch)


def _fresh_fleet():
    from paddle_tpu_torch import fleet as fleet_pkg

    return fleet_pkg._Fleet()


def test_init_server_warm_starts_from_notified_shards(tmp_path):
    from paddle_tpu_torch.fleet import Role, UserDefinedRoleMaker

    with fresh_port_programs():
        x = pt.layers.data("x", shape=[8], dtype="float32")
        loss = pt.layers.mean(pt.layers.fc(x, size=4))
        strategy = pt.fleet_pkg.DistributedStrategy()
        strategy.mode = "pserver"
        fl = _fresh_fleet()
        fl.init(UserDefinedRoleMaker(current_id=0, role=Role.SERVER,
                                     worker_num=1,
                                     server_endpoints=["127.0.0.1:1"]))
        fl._role_maker._current_endpoint = "127.0.0.1:1"
        fl.distributed_optimizer(pt.optimizer.SGD(0.1), strategy).minimize(
            loss)
        secs = [sec for plan in fl._transpiler.param_plan.values()
                for _, sec, *_ in plan]
        want = {}
        for i, sec in enumerate(secs):
            shape = tuple(fl._transpiler.origin_program.global_block().var(
                sec.rsplit(".block", 1)[0]).shape)
            want[sec] = np.full(shape, i + 0.5, np.float32)
            np.save(tmp_path / (sec + ".npy"), want[sec])
        fl.init_server(model_dir=str(tmp_path), place=pt.CPUPlace())
        for sec, value in want.items():
            np.testing.assert_array_equal(
                pt.global_scope().find_var(sec).get().numpy(), value)
        with pytest.raises(FileNotFoundError, match="no shard files"):
            fl.init_server(model_dir=str(tmp_path / "empty"),
                           place=pt.CPUPlace())


def test_collective_mode_raises_its_roadmap_item(monkeypatch):
    """The collective mode is ported (tests/test_torch_fleet_collective.py
    trains through it): one worker brings no process group up, its
    barrier is a no-op, the CollectiveOptimizer's backward,
    apply_gradients and minimize delegate to the wrapped optimizer and
    make main_program a data-parallel CompiledProgram.  What stands:
    run_server needs the PS mode, and a job of two workers with no
    coordinator endpoint raises."""
    from paddle_tpu_torch.fleet import CollectiveOptimizer
    from paddle_tpu_torch.fleet import PaddleCloudRoleMaker
    from paddle_tpu_torch.parallel import env as penv

    monkeypatch.delenv("PADDLE_PSERVERS_IP_PORT_LIST", raising=False)
    monkeypatch.delenv("TRAINING_ROLE", raising=False)
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
    monkeypatch.delenv("PADDLE_COORDINATOR_ENDPOINT", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    fl = _fresh_fleet()
    fl.init(PaddleCloudRoleMaker())
    assert not penv.is_initialized()
    fl.barrier_worker()                     # one process: no barrier
    penv.reset()
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        loss = pt.layers.mean(pt.layers.fc(x, size=1))
        opt = fl.distributed_optimizer(pt.optimizer.SGD(0.1))
        assert isinstance(opt, CollectiveOptimizer)
        params_grads = opt.backward(loss)
        assert params_grads and all(g is not None for _, g in params_grads)
        opt.apply_gradients(params_grads)
        assert [op.type for op in pt.default_main_program().global_block()
                .ops].count("sgd") == 2
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        loss = pt.layers.mean(pt.layers.fc(x, size=1))
        fl.distributed_optimizer(pt.optimizer.SGD(0.1)).minimize(loss)
        assert isinstance(fl.main_program, pt.CompiledProgram)
        assert fl.main_program._loss_name == loss.name
        assert penv.get_mesh().shape == {"dp": 1}
    penv.reset()
    with pytest.raises(RuntimeError, match="pserver"):
        fl.run_server()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(RuntimeError, match="PADDLE_COORDINATOR_ENDPOINT"):
        _fresh_fleet().init(PaddleCloudRoleMaker())


def test_new_entry_points_default_to_the_card():
    import torch

    from paddle_tpu_torch.async_executor import AsyncExecutor
    from paddle_tpu_torch.distributed.downpour_worker import DownpourRunner
    from paddle_tpu_torch.fleet import Role, UserDefinedRoleMaker
    from paddle_tpu_torch.reader import DeviceFeeder

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    with pytest.raises(pt.NoCUDADeviceError, match="CPUPlace"):
        AsyncExecutor()
    with pytest.raises(pt.NoCUDADeviceError, match="CPUPlace"):
        DeviceFeeder(iter(()))
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        loss = pt.layers.mean(pt.layers.fc(x, size=1))
        pt.optimizer.SGD(0.1).minimize(loss)
        t = pt.transpiler.DistributeTranspiler()
        t.transpile(0, pservers="127.0.0.1:1", trainers=1, sync_mode=False)
        with pytest.raises(pt.NoCUDADeviceError, match="CPUPlace"):
            DownpourRunner(t)
        strategy = pt.fleet_pkg.DistributedStrategy()
        strategy.mode = "pserver"
        fl = _fresh_fleet()
        fl.init(UserDefinedRoleMaker(role=Role.SERVER,
                                     server_endpoints=["127.0.0.1:1"]))
        fl._role_maker._current_endpoint = "127.0.0.1:1"
        fl.distributed_optimizer(pt.optimizer.SGD(0.1), strategy).minimize(
            loss)
        with pytest.raises(pt.NoCUDADeviceError, match="CPUPlace"):
            fl.init_server()
        with pytest.raises(pt.NoCUDADeviceError, match="CPUPlace"):
            fl.run_server()
