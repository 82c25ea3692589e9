"""Parameter-server training on the port (DistributeTranspiler, the
pserver ops, listen_and_serv) against the JAX package's.

- The transpiled programs are a byte-level contract: the port's trainer,
  trainer-startup, pserver and pserver-startup programs have a
  ``to_dict`` equal to ``paddle_tpu``'s for the fc model of
  tests/test_dist_ps.py, a 2-layer LM under Adam, DC-ASGD and a
  distributed lookup table.
- A 1-trainer sync cluster (pservers on threads of this process) is
  bitwise the port's local run: the merge hands one trainer's grad on
  unchanged and each pserver runs the same Adam on its row slices.
- Subprocess clusters (2 pservers x 2 trainers on localhost, the runner
  below, 20 steps): the port's sync clusters, over sockets and over HTTP,
  hold the JAX cluster's losses within SYNC_RTOL and each other's bit for
  bit; its async cluster converges like the JAX one; mixed clusters (the
  port's trainers on JAX pservers, and the reverse) hold the all-JAX
  losses within SYNC_RTOL; a trainer killed mid-run is fenced by the
  heartbeats and the survivor finishes; the distributed lookup table
  starts at the local loss and converges.

The clusters run at most three at a time, each process under
CLUSTER_TIMEOUT_S; every test waits on its cluster with a bound of its
own.
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
from torch_port_helpers import fresh_port_programs

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_lm
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models.transformer import \
    transformer_encoder_model as port_lm

STEPS = 20
# port vs JAX, sync: the same arithmetic in torch and in XLA on the CPU,
# rounding apart by ~1e-7 a step over 20 SGD steps
SYNC_RTOL = 1e-4
CLUSTER_TIMEOUT_S = 150
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    if os.environ["PADDLE_PKG"] == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax; jax.config.update("jax_platforms", "cpu")
        import paddle_tpu as fluid
        from paddle_tpu.distributed.rpc import global_rpc_client
    else:
        import torch; torch.set_num_threads(1)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.distributed.rpc import global_rpc_client
    layers, optimizer = fluid.layers, fluid.optimizer
    T = fluid.transpiler

    role = os.environ["PADDLE_TRAINING_ROLE"]
    trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    trainers = int(os.environ["PADDLE_TRAINERS_NUM"])
    eps = os.environ["PADDLE_PSERVER_EPS"]
    current_ep = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
    sync = os.environ.get("PADDLE_SYNC", "1") == "1"
    model = os.environ.get("PADDLE_MODEL", "fc")
    steps = int(os.environ["PADDLE_STEPS"])

    if model == "fc":
        np.random.seed(7)
        x = layers.data("x", shape=[13], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        pred = layers.fc(x, size=1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        optimizer.SGD(0.05).minimize(loss)
    else:
        np.random.seed(11)
        ids = layers.data("ids", shape=[5, 1], dtype="int64")
        x = layers.data("x", shape=[3], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        emb = layers.embedding(ids, size=[40, 1], is_sparse=True,
                               is_distributed=True)
        first = layers.reduce_sum(emb, dim=[1])
        pred = layers.elementwise_add(first, layers.fc(x, size=1))
        loss = layers.mean(layers.square_error_cost(pred, y))
        optimizer.SGD(0.2).minimize(loss)

    cfg = T.DistributeTranspilerConfig()
    cfg.min_block_size = 1
    hb = os.environ.get("PADDLE_HB_TIMEOUT")
    if hb:
        cfg.heartbeat_timeout = float(hb)
        cfg.heartbeat_interval = float(hb) / 6.0
    t = T.DistributeTranspiler(cfg)
    t.transpile(trainer_id, pservers=eps, trainers=trainers,
                sync_mode=sync)
    exe = fluid.Executor(fluid.CPUPlace())
    if role == "PSERVER":
        main = t.get_pserver_program(current_ep)
        exe.run(t.get_startup_program(current_ep, main))
        exe.run(main)          # blocks until the trainers complete
        sys.exit(0)

    T.wait_server_ready(eps.split(","), timeout=60)
    exe.run(t.get_trainer_startup_program())
    main = t.get_trainer_program(wait_port=False)
    rng = np.random.RandomState(100 + trainer_id)
    W = np.arange(13, dtype=np.float32)[:, None] / 13.0
    table = (np.arange(40, dtype=np.float32) % 7 - 3.0) / 10.0
    Wt = np.array([[0.5], [-0.3], [0.2]], np.float32)
    die_at = int(os.environ.get("PADDLE_DIE_AT", "-1"))
    losses = []
    for step in range(steps):
        if model == "fc":
            bx = rng.rand(32, 13).astype(np.float32)
            feed = {"x": bx, "y": bx @ W}
        else:
            bi = rng.randint(0, 40, (64, 5, 1)).astype(np.int64)
            bx = rng.rand(64, 3).astype(np.float32)
            by = table[bi[:, :, 0]].sum(axis=1, keepdims=True) + bx @ Wt
            feed = {"ids": bi, "x": bx, "y": by}
        lv, = exe.run(main, feed=feed, fetch_list=[loss])
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        if die_at >= 0 and trainer_id == 1 and step == die_at:
            os._exit(42)       # a crash: no complete, no goodbye
    for ep in eps.split(","):
        global_rpc_client().send_complete(ep,
                                          peer_id="trainer%d" % trainer_id)
    print("LOSSES " + json.dumps(losses))
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cluster(pserver_pkg="torch", trainer_pkg="torch", sync=True,
                 transport="socket", model="fc", extra_env=None,
                 allow_trainer_exit=()):
    """2 pservers and 2 trainers, each package as asked; the trainers'
    losses (of those that finished)."""
    eps = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
    env_base = {
        **os.environ, "PADDLE_TRAINERS_NUM": "2", "PADDLE_PSERVER_EPS": eps,
        "PADDLE_SYNC": "1" if sync else "0", "PADDLE_MODEL": model,
        "PADDLE_STEPS": str(STEPS), "PADDLE_TPU_RPC_TRANSPORT": transport,
        "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "",
        "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        **(extra_env or {})}
    procs, trainers = [], []
    for ep in eps.split(","):
        env = {**env_base, "PADDLE_TRAINING_ROLE": "PSERVER",
               "PADDLE_CURRENT_ENDPOINT": ep, "PADDLE_PKG": pserver_pkg}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RUNNER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for tid in range(2):
        env = {**env_base, "PADDLE_TRAINING_ROLE": "TRAINER",
               "PADDLE_TRAINER_ID": str(tid), "PADDLE_PKG": trainer_pkg}
        trainers.append(subprocess.Popen(
            [sys.executable, "-c", _RUNNER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for tid, p in enumerate(trainers):
            out, err = p.communicate(timeout=CLUSTER_TIMEOUT_S)
            if tid in allow_trainer_exit:
                assert p.returncode != 0
                continue
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out.decode())
        for p in procs:
            _, err = p.communicate(timeout=CLUSTER_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs + trainers:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("LOSSES ")]
        assert line, out
        losses.append(json.loads(line[0][len("LOSSES "):]))
    return losses


_CLUSTERS = {
    "jax_sync": dict(pserver_pkg="jax", trainer_pkg="jax"),
    "jax_async": dict(pserver_pkg="jax", trainer_pkg="jax", sync=False),
    "port_sync": dict(),
    "port_sync_http": dict(transport="http"),
    "port_async": dict(sync=False),
    "port_trainers_jax_pservers": dict(pserver_pkg="jax"),
    "jax_trainers_port_pservers": dict(trainer_pkg="jax"),
    "port_trainer_death": dict(
        extra_env={"PADDLE_DIE_AT": "4", "PADDLE_HB_TIMEOUT": "3.0"},
        allow_trainer_exit={1}),
    "port_table": dict(model="table"),
}


@pytest.fixture(scope="module")
def clusters():
    """Every cluster of this file, started at once, three at a time."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futs = {name: pool.submit(_run_cluster, **kw)
            for name, kw in _CLUSTERS.items()}
    try:
        yield futs
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _losses(clusters, name):
    return clusters[name].result(timeout=3 * CLUSTER_TIMEOUT_S)


# ---------------------------------------------------------------------------
# the transpiled programs, to_dict equal
# ---------------------------------------------------------------------------

def _fc(pkg):
    layers = pkg.layers
    x = layers.data("x", shape=[13], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    loss = layers.mean(layers.square_error_cost(layers.fc(x, size=1), y))
    pkg.optimizer.SGD(0.05).minimize(loss)


def _lm(pkg):
    model = (jax_lm if pkg is fluid else port_lm)(
        vocab_size=64, max_len=16, d_model=32, n_head=4, d_inner=64,
        n_layer=2, dropout_rate=0.0, is_test=False)
    pkg.optimizer.Adam(1e-3).minimize(model["loss"])


def _table(pkg):
    layers = pkg.layers
    ids = layers.data("ids", shape=[5, 1], dtype="int64")
    x = layers.data("x", shape=[3], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    emb = layers.embedding(ids, size=[40, 1], is_sparse=True,
                           is_distributed=True)
    pred = layers.elementwise_add(layers.reduce_sum(emb, dim=[1]),
                                  layers.fc(x, size=1))
    loss = layers.mean(layers.square_error_cost(pred, y))
    pkg.optimizer.SGD(0.2).minimize(loss)


# (build, trainers, sync, enable_dc_asgd, min_block_size)
_PLANS = {
    "fc": (_fc, 2, True, False, 1),
    "fc_async": (_fc, 2, False, False, 1),
    "lm_adam": (_lm, 2, True, False, 1024),
    "dc_asgd": (_fc, 3, False, True, 1),
    "lookup_table": (_table, 2, True, False, 1),
}
_EPS = "127.0.0.1:7164,127.0.0.1:7165"


def _programs(pkg, plan, trainer_id):
    build, trainers, sync, dc, min_block = _PLANS[plan]
    build(pkg)
    cfg = pkg.transpiler.DistributeTranspilerConfig()
    cfg.min_block_size = min_block
    cfg.enable_dc_asgd = dc
    t = pkg.transpiler.DistributeTranspiler(cfg)
    t.transpile(trainer_id, pservers=_EPS, trainers=trainers,
                sync_mode=sync)
    out = {"trainer": t.get_trainer_program(wait_port=False),
           "trainer_startup": t.get_trainer_startup_program()}
    for ep in _EPS.split(","):
        main, startup = t.get_pserver_programs(ep)
        out["pserver " + ep] = main
        out["pserver_startup " + ep] = startup
    return {k: json.dumps(p.to_dict(), sort_keys=True)
            for k, p in out.items()}


@pytest.mark.parametrize("trainer_id", [0, 1])
@pytest.mark.parametrize("plan", sorted(_PLANS))
def test_transpiled_programs_equal_jax(plan, trainer_id):
    jax = _programs(fluid, plan, trainer_id)
    with fresh_port_programs():
        port = _programs(pt, plan, trainer_id)
    assert sorted(port) == sorted(jax)
    for name in jax:
        assert port[name] == jax[name], name


def test_plan_slices_and_round_robins_like_jax():
    """The plan: [16, 64] row-sliced over both pservers, the bias whole
    on one; the trainer sends and receives each once."""
    layers = pt.layers
    with fresh_port_programs():
        x = layers.data("x", shape=[16], dtype="float32")
        loss = layers.mean(layers.fc(x, size=64))
        pt.optimizer.SGD(0.1).minimize(loss)
        cfg = pt.transpiler.DistributeTranspilerConfig()
        cfg.min_block_size = 128
        t = pt.transpiler.DistributeTranspiler(cfg)
        t.transpile(0, pservers=_EPS, trainers=2)
        w_plan = [p for n, p in t.param_plan.items() if ".w_" in n][0]
        b_plan = [p for n, p in t.param_plan.items() if ".b_" in n][0]
        tp = t.get_trainer_program(wait_port=False)
    assert [p[2:] for p in w_plan] == [(0, 8), (8, 16)]
    assert len(b_plan) == 1
    types = [op.type for op in tp.global_block().ops]
    assert types.count("send") == 2 and types.count("recv") == 2
    assert types[0] == "heartbeat_start"
    assert "send_barrier" in types and "fetch_barrier" in types


# ---------------------------------------------------------------------------
# one trainer, pservers on threads: bitwise the local run
# ---------------------------------------------------------------------------

def _serve(t, ep, errors):
    def run():
        try:
            main, startup = t.get_pserver_programs(ep)
            exe, scope = pt.Executor(pt.CPUPlace()), Scope()
            exe.run(startup, scope=scope)
            exe.run(main, scope=scope)
        except BaseException as e:   # noqa: BLE001 (reported below)
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _one_trainer_vs_local(build, feeds, min_block=1):
    from paddle_tpu_torch.distributed.rpc import global_rpc_client

    with fresh_port_programs():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            loss, params = build()
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(3)
        local = Scope()
        exe.run(startup, scope=local)
        want = [float(exe.run(main, feed=f, fetch_list=[loss],
                              scope=local)[0]) for f in feeds]
        eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
        cfg = pt.transpiler.DistributeTranspilerConfig()
        cfg.min_block_size = min_block
        t = pt.transpiler.DistributeTranspiler(cfg)
        t.transpile(0, program=main, startup_program=startup,
                    pservers=",".join(eps), trainers=1)
        errors = []
        threads = [_serve(t, ep, errors) for ep in eps]
        try:
            pt.transpiler.wait_server_ready(eps, timeout=30)
            np.random.seed(3)
            scope = Scope()
            exe.run(t.get_trainer_startup_program(), scope=scope)
            prog = t.get_trainer_program(wait_port=False)
            got = [float(exe.run(prog, feed=f, fetch_list=[loss],
                                 scope=scope)[0]) for f in feeds]
        finally:
            for ep in eps:
                global_rpc_client().send_complete(ep, peer_id="trainer0")
            for th in threads:
                th.join(timeout=30)
        assert not errors and not any(th.is_alive() for th in threads)
        assert got == want
        for name in params:
            a = local.find_var(name).get()
            b = scope.find_var(name).get()
            assert a.dtype == b.dtype and bool((a == b).all()), name


def test_one_trainer_cluster_is_bitwise_the_local_run_fc_adam():
    layers = pt.layers

    def build():
        x = layers.data("x", shape=[13], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        h = layers.fc(x, size=32, act="relu")
        loss = layers.mean(layers.square_error_cost(layers.fc(h, 1), y))
        _, pg = pt.optimizer.Adam(0.05).minimize(loss)
        return loss, [p.name for p, _ in pg]

    rng = np.random.RandomState(4)
    W = np.arange(13, dtype=np.float32)[:, None] / 13.0
    feeds = []
    for _ in range(6):
        bx = rng.rand(16, 13).astype(np.float32)
        feeds.append({"x": bx, "y": bx @ W})
    _one_trainer_vs_local(build, feeds)


def test_one_trainer_cluster_is_bitwise_the_local_run_lm():
    def build():
        model = port_lm(vocab_size=64, max_len=16, d_model=32, n_head=4,
                        d_inner=64, n_layer=2, dropout_rate=0.0,
                        is_test=False)
        _, pg = pt.optimizer.Adam(1e-3).minimize(model["loss"])
        return model["loss"], [p.name for p, _ in pg]

    ids = np.random.RandomState(5).randint(0, 64, (2, 16, 1))
    _one_trainer_vs_local(build, [{"src_ids": ids, "tgt_label": ids}] * 3,
                          min_block=64)


def test_compiled_program_drops_the_ps_ops_like_jax():
    """Met and mirrored: CompiledProgram skips send/recv/the barriers (the
    JAX package's _HOST_SKIP_SILENT), so a compiled trainer program
    trains locally and sends nothing."""
    from paddle_tpu_torch.core import compiler

    assert {"send", "recv", "send_barrier", "fetch_barrier",
            "listen_and_serv", "ps_sync_init"} <= \
        compiler._HOST_SKIP_SILENT


# ---------------------------------------------------------------------------
# the subprocess clusters
# ---------------------------------------------------------------------------

def _close(a, b, rtol=SYNC_RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=1e-7)


def test_port_sync_cluster_holds_the_jax_cluster(clusters):
    port, jax = _losses(clusters, "port_sync"), \
        _losses(clusters, "jax_sync")
    assert len(port) == len(jax) == 2
    for p, j in zip(port, jax):
        _close(p, j)
        assert p[-1] < p[0] * 0.5


def test_port_sync_cluster_over_http_is_the_socket_cluster(clusters):
    assert _losses(clusters, "port_sync_http") == \
        _losses(clusters, "port_sync")


def test_port_async_cluster_converges_like_jax(clusters):
    """Async order is the arrival order, so two runs differ, and trainer
    1 may start from parameters trainer 0 already moved.  Trainer 0's
    first step is the pushed start in both packages; every trainer
    converges, to the JAX cluster's level within a factor of 3."""
    port, jax = _losses(clusters, "port_async"), \
        _losses(clusters, "jax_async")
    _close(port[0][:1], jax[0][:1], rtol=1e-5)
    for tl in port + jax:
        assert np.mean(tl[-5:]) < 0.1 * port[0][0], tl[::5]
    ratio = np.mean([tl[-5:] for tl in port]) / \
        np.mean([tl[-5:] for tl in jax])
    assert 1 / 3 < ratio < 3


@pytest.mark.parametrize("mixed", ["port_trainers_jax_pservers",
                                   "jax_trainers_port_pservers"])
def test_mixed_clusters_hold_the_all_jax_losses(clusters, mixed):
    got, jax = _losses(clusters, mixed), _losses(clusters, "jax_sync")
    for g, j in zip(got, jax):
        _close(g, j)


def test_port_cluster_survives_a_trainer_death(clusters):
    """Trainer 1 crashes after step 4 with no goodbye; the heartbeats
    fence it, the barriers re-count and trainer 0 finishes."""
    losses = _losses(clusters, "port_trainer_death")
    assert len(losses) == 1 and len(losses[0]) == STEPS
    assert losses[0][-1] < losses[0][0] * 0.5


def test_port_distributed_lookup_table_cluster(clusters):
    """The table shards over both pservers (prefetch forward, sparse
    push backward): step 0 equals the local run, and it converges."""
    dist = _losses(clusters, "port_table")
    with fresh_port_programs():
        layers = pt.layers
        np.random.seed(11)
        ids = layers.data("ids", shape=[5, 1], dtype="int64")
        x = layers.data("x", shape=[3], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        emb = layers.embedding(ids, size=[40, 1], is_sparse=True)
        pred = layers.elementwise_add(layers.reduce_sum(emb, dim=[1]),
                                      layers.fc(x, size=1))
        loss = layers.mean(layers.square_error_cost(pred, y))
        pt.optimizer.SGD(0.2).minimize(loss)
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pt.default_startup_program())
        rng = np.random.RandomState(100)
        table = (np.arange(40, dtype=np.float32) % 7 - 3.0) / 10.0
        bi = rng.randint(0, 40, (64, 5, 1)).astype(np.int64)
        bx = rng.rand(64, 3).astype(np.float32)
        by = table[bi[:, :, 0]].sum(axis=1, keepdims=True) + bx @ np.array(
            [[0.5], [-0.3], [0.2]], np.float32)
        first = float(exe.run(feed={"ids": bi, "x": bx, "y": by},
                              fetch_list=[loss])[0])
    np.testing.assert_allclose(dist[0][0], first, rtol=1e-5)
    for tl in dist:
        assert tl[-1] < tl[0] * 0.5, tl[::5]
