"""The pool-level contracts of tests/test_model_fleet.py rerun over the
port's ReplicaPool and Predictor: the program swap and its fingerprint,
the quiesce that never overlaps a run, the probe-flake tolerance and its
``health_failures`` knob, tenant quotas through ``ServingConfig``, and
scaling the pool through its per-replica drain.

Models are built and saved by the JAX package and served by the port's
Predictors on the CPU; served outputs are held to the JAX Predictor's,
or to the port's own lone Predictor, within rtol 1e-5, atol 1e-6 (on
the CPU a row's bits may move with the batch it rides in); a Predictor
swapped back gives its earlier bits.  Every wait has a timeout.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.inference as jax_inference
from paddle_tpu import layers
import torch_port_helpers  # noqa: F401  (caps torch's threads)

from paddle_tpu_torch import inference, serving
from paddle_tpu_torch.core import compiler
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.faultinject import FaultPlan

RTOL, ATOL = 1e-5, 1e-6


def _build_model(dirname, hidden=16, in_dim=8, seed=0):
    """Save the JAX package's tiny fc net (fresh programs each call, so
    two builds in one test share nothing); returns the model dir."""
    fluid.framework.switch_main_program(fluid.Program())
    fluid.framework.switch_startup_program(fluid.Program())
    x = layers.data("x", shape=[in_dim], dtype="float32")
    h = layers.fc(x, size=hidden, act="relu")
    pred = layers.fc(h, size=1)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(seed)
    exe.run(fluid.default_startup_program())
    d = os.path.join(str(dirname), "model_h%d_s%d" % (hidden, seed))
    fluid.io.save_inference_model(d, ["x"], [pred], exe)
    return d


def _predictor(model_dir):
    cfg = inference.Config(model_dir)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def _factory(model_dir):
    return lambda i: _predictor(model_dir)


class _StubPredictor:
    """Predictor stand-in for pool-only tests (health probes never
    touch the predictor)."""

    def run(self, feeds):
        return feeds

    def feed_specs(self):
        return {}

    def get_input_names(self):
        return []


def _wait(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while not cond() and time.monotonic() < t_end:
        time.sleep(0.01)
    return cond()


# ---------------------------------------------------------------------------
# the Predictor's program swap
# ---------------------------------------------------------------------------

def test_predictor_swap_program_and_fingerprint(tmp_path):
    """swap_program replaces the loaded program in place (object
    identity kept), the returned prior state restores the exact old
    fingerprint, and a swap back replays the old compiled entry: the
    same bits, no new compile.  The port's fingerprints agree with the
    JAX package's on which programs are equal."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    p1, p2, p1b = _predictor(d1), _predictor(d2), _predictor(d1)
    fp1, fp2 = p1.program_fingerprint(), p2.program_fingerprint()
    assert fp1 != fp2 and p1b.program_fingerprint() == fp1
    j1, j2, j1b = (jax_inference.create_predictor(jax_inference.Config(d))
                   for d in (d1, d2, d1))
    assert j1.program_fingerprint() != j2.program_fingerprint()
    assert j1b.program_fingerprint() == j1.program_fingerprint()

    x = np.random.RandomState(5).rand(2, 8).astype(np.float32)
    out1, = p1.run([x])
    out2_direct, = p2.run([x])
    np.testing.assert_allclose(out1, np.asarray(j1.run([x])[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out2_direct, np.asarray(j2.run([x])[0]),
                               rtol=RTOL, atol=ATOL)
    compiled1 = p1._compiled
    prior = p1.swap_program(p2)
    assert p1.program_fingerprint() == fp2
    out_swapped, = p1.run([x])
    np.testing.assert_array_equal(out_swapped, out2_direct)
    compiles = compiler._M_COMPILES.total()
    p1.swap_program(prior)                      # rollback
    assert p1.program_fingerprint() == fp1
    assert p1._compiled is compiled1 and p1._scope is prior["_scope"]
    out_back, = p1.run([x])
    np.testing.assert_array_equal(out_back, out1)
    assert compiler._M_COMPILES.total() == compiles   # no new compile
    with pytest.raises(ValueError):
        p1.swap_program({"_program": None})     # malformed state


def test_pool_swap_predictor_under_traffic_and_rollback(tmp_path):
    """ReplicaPool.swap_predictor under live traffic: requests after the
    swap get the new model's rows, the rollback restores the old
    fingerprint and rows, no request is dropped."""
    d1 = _build_model(tmp_path, hidden=16, seed=0)
    d2 = _build_model(tmp_path, hidden=16, seed=1)
    x = np.ones((1, 8), np.float32)
    want1, = _predictor(d1).run([x])
    want2, = _predictor(d2).run([x])
    assert not np.allclose(want1, want2, rtol=RTOL, atol=ATOL)
    cfg = serving.ServingConfig(n_replicas=1, max_batch=2,
                                default_deadline_s=20.0,
                                queue_capacity=64, prewarm=True)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        rep = srv.pool.replicas[0]
        fp1 = rep.predictor.program_fingerprint()
        stop = threading.Event()
        futures = []

        def pump():
            while not stop.is_set():
                try:
                    futures.append(srv.submit({"x": x}))
                except serving.ServingError:
                    pass
                time.sleep(0.002)

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        try:
            time.sleep(0.05)
            prior, prior_version = srv.pool.swap_predictor(
                0, _predictor(d2), version="v2")
            assert prior_version is None and rep.version == "v2"
            np.testing.assert_allclose(
                srv.infer({"x": x}, timeout=20)[0], want2, rtol=RTOL,
                atol=ATOL)
            srv.pool.swap_predictor(0, prior, version=None)
            assert rep.predictor.program_fingerprint() == fp1
            np.testing.assert_allclose(
                srv.infer({"x": x}, timeout=20)[0], want1, rtol=RTOL,
                atol=ATOL)
        finally:
            stop.set()
            th.join(timeout=5.0)
        assert not th.is_alive()
        for f in futures:
            out, = f.result(timeout=20.0)
            assert np.allclose(out, want1, rtol=RTOL, atol=ATOL) or \
                np.allclose(out, want2, rtol=RTOL, atol=ATOL)
        st = srv.stats()
        assert st["accounted"] and st["outstanding"] == 0
        assert st["pool"]["batches_failed"] == 0


def test_quiesce_never_overlaps_inflight_run(tmp_path):
    """swap_program's 'no run() in flight' contract holds under
    repeated swaps with live traffic: the worker raises ``busy`` before
    its post-take pause re-check, so a quiesce never observes
    busy == False while a batch is about to execute."""
    d1 = _build_model(tmp_path, hidden=16)
    d2 = _build_model(tmp_path, hidden=24)
    cfg = serving.ServingConfig(n_replicas=1, max_batch=2,
                                default_deadline_s=20.0,
                                queue_capacity=64)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        rep = srv.pool.replicas[0]
        flag = {"running": False, "overlaps": 0}
        orig_run = rep.predictor.run
        orig_swap = rep.predictor.swap_program

        def run(feeds):
            flag["running"] = True
            try:
                time.sleep(0.001)
                return orig_run(feeds)
            finally:
                flag["running"] = False

        def swap_program(source):
            if flag["running"]:
                flag["overlaps"] += 1
            return orig_swap(source)

        rep.predictor.run = run
        rep.predictor.swap_program = swap_program
        other = _predictor(d2)
        stop = threading.Event()
        futures = []

        def pump():
            while not stop.is_set():
                try:
                    futures.append(
                        srv.submit({"x": np.ones((1, 8), np.float32)}))
                except serving.ServingError:
                    pass
                time.sleep(0.001)

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        try:
            source = other
            for _ in range(30):
                source, _ = srv.pool.swap_predictor(0, source)
        finally:
            stop.set()
            th.join(timeout=5.0)
        assert not th.is_alive()
        assert flag["overlaps"] == 0
        for f in futures:
            f.result(timeout=20.0)
        st = srv.stats()
        assert st["accounted"] and st["outstanding"] == 0


# ---------------------------------------------------------------------------
# health-probe flake tolerance
# ---------------------------------------------------------------------------

def test_health_probe_flake_tolerance_faultinject_delay():
    """One seeded delayed+dropped probe does not kill a healthy replica
    (K=2): the breaker stays closed.  K consecutive probe failures do
    open it (breaker_threshold=1 isolates the probe path)."""
    plan = FaultPlan()
    plan.on("serving_health", 0, "delay=0.01+drop")
    with faultinject.installed(plan):
        pool = serving.ReplicaPool(lambda i: _StubPredictor(),
                                   n_replicas=1,
                                   breaker_threshold=1,
                                   breaker_cooldown_s=5.0,
                                   health_interval_s=0.02,
                                   health_failures=2)
        pool.start()
        try:
            assert _wait(lambda: pool.counters()["probes"] >= 4)
            rep = pool.replicas[0]
            assert pool.counters()["probe_failures"] == 1
            assert not rep.breaker_open()       # flake tolerated
            assert rep.available()
        finally:
            pool.stop()

    plan2 = FaultPlan()
    plan2.on("serving_health", 0, "drop")
    plan2.on("serving_health", 1, "drop")
    with faultinject.installed(plan2):
        pool = serving.ReplicaPool(lambda i: _StubPredictor(),
                                   n_replicas=1,
                                   breaker_threshold=1,
                                   breaker_cooldown_s=5.0,
                                   health_interval_s=0.02,
                                   health_failures=2)
        pool.start()
        try:
            assert _wait(lambda: pool.counters()["probe_failures"] >= 2)
            assert pool.replicas[0].breaker_open()
        finally:
            pool.stop()


def test_health_failures_env_knob(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_HEALTH_FAILURES", "5")
    pool = serving.ReplicaPool(lambda i: _StubPredictor(),
                               n_replicas=1, health_interval_s=10.0)
    assert pool._health_failures == 5
    pool2 = serving.ReplicaPool(lambda i: _StubPredictor(),
                                n_replicas=1, health_interval_s=10.0,
                                health_failures=1)
    assert pool2._health_failures == 1
    monkeypatch.delenv("PADDLE_TPU_HEALTH_FAILURES")
    pool3 = serving.ReplicaPool(lambda i: _StubPredictor(),
                                n_replicas=1, health_interval_s=10.0)
    assert pool3._health_failures == 2


# ---------------------------------------------------------------------------
# tenant quotas through the server's config
# ---------------------------------------------------------------------------

class _GatedPredictor:
    """A Predictor whose run() waits for a gate: requests stay
    outstanding until the test opens it."""

    def __init__(self, inner, gate):
        self._inner, self._gate = inner, gate

    def run(self, feeds):
        self._gate.wait(timeout=20.0)
        return self._inner.run(feeds)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_tenant_quotas_through_serving_config(tmp_path):
    """``ServingConfig(quotas=...)`` takes TenantQuota objects and dicts;
    a tenant at max_outstanding sheds with the typed QuotaExceededError
    while other tenants are admitted, ``set_quota`` changes it at run
    time, and every admitted request is answered with the JAX
    Predictor's rows."""
    d = _build_model(tmp_path, hidden=16)
    x = np.random.RandomState(2).rand(1, 8).astype(np.float32)
    want, = jax_inference.create_predictor(jax_inference.Config(d)).run([x])
    gate = threading.Event()
    cfg = serving.ServingConfig(
        n_replicas=1, max_batch=2, default_deadline_s=20.0,
        queue_capacity=32,
        quotas={"a": serving.TenantQuota(max_outstanding=2),
                "b": {"max_outstanding": 1, "weight": 2.0}})
    assert isinstance(cfg.quotas["b"], serving.TenantQuota)
    assert cfg.quotas["b"].weight == 2.0
    srv = serving.InferenceServer(
        lambda i: _GatedPredictor(_predictor(d), gate), cfg).start()
    try:
        admitted = [srv.submit({"x": x}, tenant="a") for _ in range(2)]
        with pytest.raises(serving.QuotaExceededError) as ei:
            srv.submit({"x": x}, tenant="a")
        assert ei.value.code == "quota"
        admitted.append(srv.submit({"x": x}, tenant="b"))
        with pytest.raises(serving.QuotaExceededError):
            srv.submit({"x": x}, tenant="b")
        admitted.append(srv.submit({"x": x}))          # no tenant
        srv.set_quota("a", serving.TenantQuota(max_outstanding=3))
        admitted.append(srv.submit({"x": x}, tenant="a"))
        gate.set()
        for req in admitted:
            out, = req.result(timeout=20)
            np.testing.assert_allclose(out, np.asarray(want), rtol=RTOL,
                                       atol=ATOL)
        st = srv.stats()
        assert st["accounted"]
        assert st["admission"]["rejected_quota"] == 2
        assert st["tenants"]["a"]["admitted"] == 3
        assert st["tenants"]["a"]["rejected_quota"] == 1
        assert st["tenants"]["b"]["admitted"] == 1
    finally:
        gate.set()
        srv.stop()


# ---------------------------------------------------------------------------
# scaling the pool through its per-replica drain
# ---------------------------------------------------------------------------

def test_add_and_remove_replica_through_the_drain(tmp_path):
    """add_replica starts a new worker that serves (from the pool's
    factory, or ``set_factory``'s); remove_replica retires one through
    the quiesce, never resurrected by restart_dead, and refuses the last
    live one unless forced."""
    d1 = _build_model(tmp_path, hidden=16, seed=0)
    d2 = _build_model(tmp_path, hidden=16, seed=3)
    x = np.ones((1, 8), np.float32)
    want2, = _predictor(d2).run([x])
    cfg = serving.ServingConfig(n_replicas=1, max_batch=2,
                                default_deadline_s=20.0,
                                queue_capacity=32, restart_dead=True)
    with serving.InferenceServer(_factory(d1), cfg) as srv:
        pool = srv.pool
        pool.set_factory(_factory(d2))
        idx = pool.add_replica(version="v2")
        assert idx == 1 and pool.live_replicas() == [0, 1]
        assert pool.replica(1).version == "v2"
        futures = [srv.submit({"x": x}) for _ in range(12)]
        assert pool.remove_replica() == 1
        for f in futures:
            f.result(timeout=20.0)       # all answered, none dropped
        time.sleep(0.15)                 # restart_dead must not
        assert pool.live_replicas() == [0]   # resurrect the retiree
        with pytest.raises(RuntimeError):
            pool.remove_replica()        # the last live replica
        idx = pool.add_replica(predictor=_predictor(d2))
        assert idx == 2                  # indices are never reused
        pool.quiesce_replica(0)          # only the new one serves now
        try:
            np.testing.assert_allclose(
                srv.infer({"x": x}, timeout=20)[0], want2, rtol=RTOL,
                atol=ATOL)
        finally:
            pool.resume_replica(0)
        st = srv.stats()
        assert st["accounted"] and st["outstanding"] == 0
        assert set(st["pool"]["replicas"]) == {0, 2}
