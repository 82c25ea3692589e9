"""The port's async Communicator, AsyncCheckpointer and ElasticTrainer,
held to the JAX package's contracts.

- Communicator (``tests/test_fault_tolerance.py:491-600``): ``stop()``
  drains every queued grad, a dead send thread is restarted by the
  supervisor and its grad ships late, the per-var queue applies
  backpressure; in-process async updates reach the trainer's scope
  (``tests/test_dist_ps.py:349``), as fresh tensors swapped in.
- AsyncCheckpointer (a format of the port's own): a step is committed
  whole by a rename, ``latest_step`` sees committed steps only,
  ``restore`` refuses a checkpoint holding state the scope lacks,
  ``max_to_keep`` keeps the newest.
- ElasticTrainer: single-process crash-resume is bit for bit the
  uninterrupted run (``test_fault_tolerance.py:611``); a 1-trainer sync
  cluster on threads with Momentum on the pservers resumes exactly from
  the pservers' step snapshots (``ps_state_dir``), which exist with
  their manifests.
"""

from __future__ import annotations

import glob
import os
import queue as queue_mod
import socket
import threading
import time

import numpy as np
import pytest
import torch
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch.communicator import Communicator
from paddle_tpu_torch.contrib.checkpoint import AsyncCheckpointer
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.distributed.elastic import ElasticTrainer
from paddle_tpu_torch.distributed.rpc import RPCServer, global_rpc_client


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# Communicator
# ---------------------------------------------------------------------------

class _StubTranspiler:
    """Minimal section-plan surface Communicator needs."""

    def __init__(self, ep):
        self.endpoints = [ep]
        self.trainer_id = 0
        self.param_plan = {"w": [(0, "w.block0", 0, -1)]}
        self.grad_of = {"w": "w@GRAD"}

    def _grad_section_name(self, pname, sec):
        return sec.replace(pname, self.grad_of[pname], 1)


def _comm_server():
    server = RPCServer("127.0.0.1:0")
    got = []
    server.register_handler(
        "send_var", lambda p: got.append(np.asarray(p[1]).copy()))
    server.register_handler("get_var", lambda p: np.zeros(4, np.float32))
    server.start()
    return server, got


def test_communicator_stop_drains_every_queued_grad():
    server, got = _comm_server()
    try:
        comm = Communicator(_StubTranspiler(server.endpoint), Scope(),
                            max_merge_var_num=1, send_wait_times=0.01)
        comm.start()
        for i in range(40):
            value = np.full(4, float(i), np.float32)
            comm.put("w@GRAD", torch.from_numpy(value) if i % 2 else value)
        comm.stop()
        assert len(got) == 40                         # every put arrived
        assert sorted(float(g[0]) for g in got) == \
            [float(i) for i in range(40)]             # no dup, no loss
        assert comm.errors() == []
        with pytest.raises(KeyError, match="unknown grad"):
            comm.put("nope@GRAD", np.zeros(4))
    finally:
        server.stop()


def test_communicator_supervisor_restarts_dead_send_thread():
    server, got = _comm_server()

    class _Flaky(Communicator):
        fail_remaining = 2

        def _send_grad(self, g, m):
            if self.fail_remaining > 0:
                self.fail_remaining -= 1
                raise RuntimeError("induced send failure")
            super()._send_grad(g, m)

    try:
        comm = _Flaky(_StubTranspiler(server.endpoint), Scope(),
                      max_merge_var_num=1, send_wait_times=0.01,
                      restart_backoff=0.02)
        comm.start()
        comm.put("w@GRAD", np.full(4, 7.0, np.float32))
        deadline = time.monotonic() + 20
        while not got and time.monotonic() < deadline:
            time.sleep(0.05)
        comm.stop()
        assert len(got) == 1 and got[0][0] == 7.0     # delivered once
        errs = comm.errors()
        assert len(errs) == 2 and all(n == "send" for n, _ in errs)
        assert comm.restarts()["send"] >= 2
    finally:
        server.stop()


def test_communicator_bounded_queue_backpressure():
    comm = Communicator(_StubTranspiler("127.0.0.1:1"), Scope(),
                        max_merge_var_num=2, max_queue_per_var=3)
    for _ in range(3):
        comm.put("w@GRAD", np.ones(2))
    with pytest.raises(queue_mod.Full):     # not started: queue fills
        comm.put("w@GRAD", np.ones(2), block=False)


def test_communicator_async_updates_params_in_process():
    ep = f"127.0.0.1:{_free_port()}"
    with fresh_port_programs():
        x = pt.layers.data("x", shape=[4], dtype="float32")
        loss = pt.layers.mean(pt.layers.fc(x, size=1, bias_attr=False))
        pt.optimizer.SGD(0.1).minimize(loss)
        cfg = pt.transpiler.DistributeTranspilerConfig()
        cfg.sync_mode = False
        t = pt.transpiler.DistributeTranspiler(cfg)
        t.transpile(0, pservers=ep, trainers=1, sync_mode=False)
        exe = pt.Executor(pt.CPUPlace())
        ps_main, ps_startup = t.get_pserver_programs(ep)
        ps_scope = Scope()
        exe.run(ps_startup, scope=ps_scope)
        server = threading.Thread(
            target=lambda: exe.run(ps_main, scope=ps_scope), daemon=True)
        server.start()
        scope = Scope()
        np.random.seed(1)
        exe.run(t.get_trainer_startup_program(), scope=scope)
        pname = next(iter(t.param_plan))
        first = scope.find_var(pname).get()
        p0 = first.clone()
        comm = Communicator(t, scope).start()
        g = np.ones(tuple(p0.shape), np.float32)
        for _ in range(5):
            comm.put(t.grad_of[pname], g)
        deadline = time.time() + 20
        moved = False
        while time.time() < deadline:
            time.sleep(0.1)
            cur = scope.find_var(pname).get()
            if bool((cur < p0 - 0.05).all()):   # SGD steps on +1 grads
                moved = True
                break
        comm.stop()
        global_rpc_client().send_complete(ep, peer_id="trainer0")
        server.join(timeout=10)
    assert moved, (p0, cur)
    assert cur is not first and torch.equal(first, p0)   # swapped, not
    assert comm.errors() == []                           # written into


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------

def _fc_state():
    x = pt.layers.data("x", shape=[8], dtype="float32")
    y = pt.layers.data("y", shape=[1], dtype="float32")
    loss = pt.layers.mean(pt.layers.square_error_cost(
        pt.layers.fc(x, 1), y))
    pt.optimizer.Adam(0.05).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    np.random.seed(0)
    exe.run(pt.default_startup_program())
    return exe, loss


def test_checkpointer_commits_whole_steps_and_refuses_foreign_state(
        tmp_path):
    with fresh_port_programs():
        exe, _ = _fc_state()
        scope = pt.global_scope()
        ck = AsyncCheckpointer(str(tmp_path), max_to_keep=2)
        assert ck.latest_step() is None
        names = ck.save(3)
        assert "fc_0.w_0" in names and any("moment" in n for n in names)
        ck.wait()
        os.makedirs(tmp_path / "step_9.tmp")       # a torn write: unseen
        assert ck.latest_step() == 3
        w = scope.find_var("fc_0.w_0").get()
        scope.var("fc_0.w_0").set(w + 1.0)
        for s in (4, 5):
            ck.save(s)
        ck.wait()
        assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5",
                                                "step_9.tmp"]
        ck.restore(4)
        assert torch.equal(scope.find_var("fc_0.w_0").get(), w + 1.0)
        ck.close()
    with fresh_port_programs():            # a smaller program: refused
        x = pt.layers.data("x", shape=[8], dtype="float32")
        pt.layers.fc(x, 1)
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
        ck = AsyncCheckpointer(str(tmp_path))
        with pytest.raises(RuntimeError, match="absent from the current"):
            ck.restore()
        ck.close()


# ---------------------------------------------------------------------------
# ElasticTrainer
# ---------------------------------------------------------------------------

def _elastic_net():
    np.random.seed(0)
    x = pt.layers.data("x", shape=[8], dtype="float32")
    y = pt.layers.data("y", shape=[1], dtype="float32")
    pred = pt.layers.fc(x, 1, bias_attr=False)
    loss = pt.layers.mean(pt.layers.square_error_cost(pred, y))
    pt.optimizer.Adam(0.05).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program())

    def step_fn(step):
        rng = np.random.RandomState(100 + step)   # step-keyed data
        bx = rng.rand(16, 8).astype(np.float32)
        lv, = exe.run(feed={"x": bx, "y": bx.sum(1, keepdims=True)},
                      fetch_list=[loss])
        return float(lv)

    return step_fn


def test_elastic_crash_resume_bit_parity(tmp_path):
    with fresh_port_programs():
        step_fn = _elastic_net()
        ck = AsyncCheckpointer(str(tmp_path / "ref"))
        ref = ElasticTrainer(ck, save_every=4,
                             wait_each_save=True).run(12, step_fn)
        ck.close()
    assert len(ref) == 12

    with fresh_port_programs():          # incarnation 1: crashes
        step_fn = _elastic_net()
        ck = AsyncCheckpointer(str(tmp_path / "crash"))
        el = ElasticTrainer(ck, save_every=4, wait_each_save=True)
        assert el.resume() == 0
        for step in range(9):             # dies after step 8;
            assert step_fn(step) == ref[step]
            el.step_done(step)            # ckpt@4, ckpt@8 durable
        ck.close()                        # scope abandoned = crash

    with fresh_port_programs():          # incarnation 2: resumes
        step_fn = _elastic_net()
        ck = AsyncCheckpointer(str(tmp_path / "crash"))
        el = ElasticTrainer(ck, save_every=4, wait_each_save=True)
        start = el.resume()
        assert start == 8                 # latest durable checkpoint
        tail = el.run(12, step_fn, start_step=start)
        ck.close()
    assert tail == ref[8:12]              # bit-for-bit


def _ps_leg(root, die_after=None, steps=10):
    """One sync pserver on a thread with Momentum on it, and a trainer
    that may 'crash' (abandon its scope after ``die_after``) and come
    back as a new incarnation resuming from the checkpoints; returns
    the start step of the last incarnation and {step: loss}."""
    ep = f"127.0.0.1:{_free_port()}"
    with fresh_port_programs():
        np.random.seed(7)
        x = pt.layers.data("x", shape=[13], dtype="float32")
        y = pt.layers.data("y", shape=[1], dtype="float32")
        loss = pt.layers.mean(pt.layers.square_error_cost(
            pt.layers.fc(x, size=1), y))
        pt.optimizer.Momentum(0.05, momentum=0.9).minimize(loss)
        cfg = pt.transpiler.DistributeTranspilerConfig()
        cfg.min_block_size = 1
        cfg.heartbeat_timeout = 120.0
        t = pt.transpiler.DistributeTranspiler(cfg)
        t.transpile(0, pservers=ep, trainers=1, sync_mode=True)
        exe = pt.Executor(pt.CPUPlace())
        ps_main, ps_startup = t.get_pserver_programs(ep)
        ps_scope = Scope()
        exe.run(ps_startup, scope=ps_scope)
        server = threading.Thread(
            target=lambda: exe.run(ps_main, scope=ps_scope), daemon=True)
        server.start()
        main = t.get_trainer_program()
        W = np.arange(13, dtype=np.float32)[:, None] / 13.0
        losses, start = {}, None
        for life in range(2 if die_after is not None else 1):
            scope = Scope()
            np.random.seed(7)
            exe.run(t.get_trainer_startup_program(), scope=scope)
            ck = AsyncCheckpointer(str(root / "ck"))
            el = ElasticTrainer(ck, transpiler=t, save_every=3,
                                wait_each_save=True, program=main,
                                scope=scope, ps_state_dir=str(root / "ps"))
            start = el.resume()
            for step in range(start, steps):
                rng = np.random.RandomState(5000 + step)
                bx = rng.rand(32, 13).astype(np.float32)
                lv, = exe.run(main, feed={"x": bx, "y": bx @ W},
                              fetch_list=[loss], scope=scope)
                losses[step] = float(lv)
                el.step_done(step)
                if life == 0 and step == die_after:
                    break                 # crash: no goodbye, no complete
            ck.close()
        el.finish()
        global_rpc_client().send_complete(ep, peer_id="trainer0")
        server.join(timeout=30)
        assert not server.is_alive()
    return start, losses


def test_elastic_ps_resume_exact_with_stateful_pserver_optimizer(tmp_path):
    start_u, clean = _ps_leg(tmp_path / "clean")
    assert start_u == 0 and len(clean) == 10
    start_r, resumed = _ps_leg(tmp_path / "crash", die_after=7)
    assert start_r == 6                   # latest durable checkpoint
    steps = sorted(glob.glob(str(tmp_path / "crash" / "ps" / "ps_*" /
                                 "step_*")))
    assert {"step_3", "step_6"} <= {os.path.basename(s) for s in steps}
    assert all(os.path.exists(os.path.join(s, "MANIFEST.json"))
               for s in steps)
    for step in range(10):
        assert resumed[step] == clean[step], step
