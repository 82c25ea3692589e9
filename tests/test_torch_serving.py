"""The port's serving tier against the JAX package's: the 12 fast
contracts of tests/test_serving.py rerun over ``paddle_tpu_torch``'s
InferenceServer, and the slice as a whole on a tiny LM.

Every model is built and saved by the JAX package
(``paddle_tpu.io.save_inference_model``) and served by the port's
Predictors on the CPU (``Config.disable_gpu()``).  Served outputs are
held to the JAX Predictor's on the same rows: the fc net within rtol
1e-5, atol 1e-6 (the same f32 products in another order); the LM within
rtol = atol = 1e-4, the bar of tests/test_torch_inference.py (XLA jits
the whole block, the port runs op by op).

Fault plans go through the port's own injector
(``paddle_tpu_torch.distributed.faultinject``): the port's replicas
consult it, not the JAX package's.  Every wait has a timeout.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.inference as jax_inference
from paddle_tpu import layers
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_lm
from torch_port_helpers import TINY_LM

from paddle_tpu_torch import inference, serving
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.faultinject import FaultPlan

RTOL, ATOL = 1e-5, 1e-6        # the fc net against the JAX Predictor
LM_TOL = 1e-4                  # the LM against the JAX Predictor
LM = dict(TINY_LM, max_len=32)


def _save_model(tmp_path, in_dim=8):
    """The JAX package's tiny fc net saved as an inference model;
    returns (dir, probe, the JAX Predictor's outputs for the probe)."""
    x = layers.data("x", shape=[in_dim], dtype="float32")
    h = layers.fc(x, size=16, act="relu")
    pred = layers.fc(h, size=1)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "model")
    fluid.io.save_inference_model(d, ["x"], [pred], exe)
    probe = np.random.RandomState(0).rand(8, in_dim).astype(np.float32)
    expect, = jax_inference.create_predictor(
        jax_inference.Config(d)).run([probe])
    return d, probe, np.asarray(expect)


def _predictor(model_dir):
    cfg = inference.Config(model_dir)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def _factory(model_dir):
    return lambda i: _predictor(model_dir)


class _SlowPredictor:
    """Predictor wrapper whose run() sleeps — a wedged/slow replica."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self._delay = delay_s

    def run(self, feeds):
        time.sleep(self._delay)
        return self._inner.run(feeds)

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# typed feed validation in the Predictor
# ---------------------------------------------------------------------------

def test_predictor_feed_validation_typed_errors(tmp_path):
    """A wrong name/shape/dtype feed raises FeedValidationError naming
    the offending feed before any op runs."""
    d, probe, expect = _save_model(tmp_path)
    p = _predictor(d)
    specs = p.feed_specs()
    assert "x" in specs and specs["x"][1] == np.dtype("float32")

    with pytest.raises(inference.FeedValidationError) as ei:
        p.run([probe.astype(np.float64)])           # wrong dtype
    assert "'x'" in str(ei.value) and "float64" in str(ei.value)
    with pytest.raises(inference.FeedValidationError) as ei:
        p.run([probe[:, :5]])                       # wrong trailing dim
    assert "'x'" in str(ei.value) and "shape" in str(ei.value)
    with pytest.raises(inference.FeedValidationError):
        p.run([probe.reshape(8, 2, 4)])             # wrong rank
    with pytest.raises(inference.FeedValidationError):
        p.run([probe, probe])                       # wrong feed count
    with pytest.raises(inference.FeedValidationError) as ei:
        p.validate_feeds({"y": probe})              # unknown + missing
    assert "missing" in str(ei.value)
    with pytest.raises(inference.FeedValidationError) as ei:
        p.validate_feeds({"x": probe, "y": probe})
    assert "'y'" in str(ei.value)
    out, = p.run([probe[:3]])                       # any batch extent
    np.testing.assert_allclose(out, expect[:3], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# roundtrip + compile-once bucket cache
# ---------------------------------------------------------------------------

def test_server_roundtrip_and_compile_once_bucket_cache(tmp_path):
    """Mixed-size requests batch, pad to buckets, and come back
    per-request equal to the JAX Predictor's rows; the predictor's
    compile cache holds at most one entry per bucket."""
    d, probe, expect = _save_model(tmp_path)
    cfg = serving.ServingConfig(n_replicas=1, max_batch=8,
                                max_wait_s=0.005,
                                default_deadline_s=10.0)
    with serving.InferenceServer(_factory(d), cfg) as srv:
        reqs, slices = [], []
        for rows, off in [(1, 0), (3, 1), (2, 4), (1, 6), (1, 7),
                          (2, 0), (3, 3)]:
            reqs.append(srv.submit({"x": probe[off:off + rows]}))
            slices.append((rows, off))
        for req, (rows, off) in zip(reqs, slices):
            out, = req.result(timeout=30)
            np.testing.assert_allclose(out, expect[off:off + rows],
                                       rtol=RTOL, atol=ATOL)
        st = srv.stats()
        assert st["accounted"] and st["admission"]["answered_ok"] == 7
        assert st["batcher"]["bucket_shapes"] <= len(cfg.buckets)
        n_compiled = len(
            srv.pool.replicas[0].predictor._compiled._cache)
        assert 0 < n_compiled <= len(cfg.buckets)
    assert srv.stats()["outstanding"] == 0


def test_default_buckets_and_bucket_for():
    assert serving.default_buckets(8) == (1, 2, 4, 8)
    assert serving.default_buckets(12) == (1, 2, 4, 8, 12)
    with pytest.raises(ValueError):
        serving.default_buckets(0)
    b = serving.ShapeBucketBatcher(None, None, buckets=(1, 2, 4, 8))
    assert b.bucket_for(3) == 4 and b.bucket_for(8) == 8
    assert b.bucket_for(9) == 9      # oversized: exact, uncached
    feeds = {"x": np.zeros((3, 8), np.float32),
             "a": np.zeros((3, 2, 2), np.int64)}
    assert serving.signature_of(feeds) == (
        ("a", (2, 2), "int64"), ("x", (8,), "float32"))


# ---------------------------------------------------------------------------
# admission control + deadlines
# ---------------------------------------------------------------------------

def test_overload_sheds_with_typed_reply_never_silently(tmp_path):
    """Over capacity, submit() rejects with the typed OverloadedError
    immediately; every ADMITTED request is still answered."""
    d, probe, _ = _save_model(tmp_path)
    base = _factory(d)
    cfg = serving.ServingConfig(
        n_replicas=1, max_batch=2, max_wait_s=0.001,
        default_deadline_s=10.0, queue_capacity=4,
        dispatch_capacity=1)
    srv = serving.InferenceServer(
        lambda i: _SlowPredictor(base(i), 0.15), cfg).start()
    try:
        admitted, shed = [], 0
        for _ in range(30):
            try:
                admitted.append(srv.submit({"x": probe[:1]}))
            except serving.OverloadedError:
                shed += 1
        assert shed > 0                       # typed, immediate
        for req in admitted:
            req.result(timeout=30)            # all admitted answered
        st = srv.stats()
        assert st["accounted"]
        assert st["admission"]["rejected_overloaded"] == shed
        assert st["admission"]["answered_ok"] == len(admitted)
    finally:
        srv.stop()


def test_deadline_sheds_before_batch_and_before_delivery(tmp_path):
    """Expired requests are answered with the typed expired error —
    before batch formation (no compute spent) and, for requests that
    expire while their batch computes, before result delivery."""
    d, probe, _ = _save_model(tmp_path)
    base = _factory(d)
    cfg = serving.ServingConfig(
        n_replicas=1, max_batch=2, max_wait_s=0.001,
        default_deadline_s=0.08, queue_capacity=64,
        dispatch_capacity=1)
    srv = serving.InferenceServer(
        lambda i: _SlowPredictor(base(i), 0.12), cfg).start()
    try:
        reqs = [srv.submit({"x": probe[:1]}) for _ in range(10)]
        outcomes = {"ok": 0, "expired": 0}
        for req in reqs:
            try:
                req.result(timeout=30)
                outcomes["ok"] += 1
            except serving.DeadlineExpiredError:
                outcomes["expired"] += 1
        assert outcomes["expired"] > 0
        st = srv.stats()
        assert st["accounted"]
        # far fewer batches ran than requests: the sheds saved compute
        ran = sum(r.batches for r in srv.pool.replicas)
        assert ran < len(reqs)
        shed_early = st["batcher"]["shed_expired"] + \
            st["pool"]["shed_expired_batches"]
        assert shed_early + st["admission"]["answered_expired"] > 0
    finally:
        srv.stop()


def test_max_wait_timer_bounds_latency_at_low_load(tmp_path):
    """A lone request must not wait for batch-mates beyond max_wait."""
    d, probe, expect = _save_model(tmp_path)
    cfg = serving.ServingConfig(n_replicas=1, max_batch=8,
                                max_wait_s=0.02,
                                default_deadline_s=10.0)
    with serving.InferenceServer(_factory(d), cfg) as srv:
        srv.infer({"x": probe[:1]}, timeout=30)   # warm the bucket
        t0 = time.monotonic()
        out, = srv.infer({"x": probe[:1]}, timeout=30)
        latency = time.monotonic() - t0
        np.testing.assert_allclose(out, expect[:1], rtol=RTOL, atol=ATOL)
        assert latency < 1.0        # bounded; never waits to fill 8


# ---------------------------------------------------------------------------
# failover + exactly-once + drain under a seeded fault plan
# ---------------------------------------------------------------------------

def test_failover_exactly_once_accounting_and_drain(tmp_path):
    """Under a seeded plan that kills one replica mid-batch, delays a
    health reply and drops one reply frame, the server answers EVERY
    admitted request exactly once with the JAX Predictor's rows, keeps
    serving on the survivor with the failed batch requeued, and drain()
    completes all in-flight work."""
    d, probe, expect = _save_model(tmp_path)
    plan = (FaultPlan()
            .on("serving_infer", 1, "kill")       # replica dies mid-batch
            .on("serving_infer", 3, "drop")       # reply frame lost
            .on("serving_health", 0, "delay=0.2"))  # slow health reply
    cfg = serving.ServingConfig(
        n_replicas=2, max_batch=4, max_wait_s=0.005,
        default_deadline_s=30.0, restart_dead=False,
        health_interval_s=0.05, queue_capacity=64)
    rng = np.random.RandomState(1)
    with faultinject.installed(plan) as inj:
        srv = serving.InferenceServer(_factory(d), cfg).start()
        reqs = []
        for i in range(24):
            row = int(rng.randint(0, len(probe)))
            reqs.append((row, srv.submit({"x": probe[row:row + 1]},
                                         request_id=f"req-{i}")))
            time.sleep(0.002)
        answered_ids = set()
        for row, req in reqs:
            out, = req.result(timeout=60)     # raises on a typed reply
            np.testing.assert_allclose(out, expect[row:row + 1],
                                       rtol=RTOL, atol=ATOL)
            answered_ids.add(req.id)
            assert not req.complete([out])    # second answer refused
        assert answered_ids == {f"req-{i}" for i in range(24)}
        leftovers = srv.stop()
        st = srv.stats()
        assert leftovers == 0                 # drain fully clean
        assert st["accounted"] and st["outstanding"] == 0
        assert st["admission"]["admitted"] == 24
        assert st["admission"]["answered_ok"] == 24
        kinds = {k for _, _, k in inj.log}
        assert "kill" in kinds and "drop" in kinds
        assert st["pool"]["requeues"] >= 2
        # one replica died, the other served on (which one took the
        # second batch is the threads' race)
        live = srv.pool.live_replicas()
        assert len(live) == 1
        dead, = {0, 1} - set(live)
        assert st["pool"]["replicas"][dead]["alive"] is False
        assert st["pool"]["replicas"][live[0]]["alive"] is True
    assert faultinject.maybe_injector() is None


def test_drain_answers_stragglers_with_typed_shutdown(tmp_path):
    """drain() completes what it can and answers the rest with the
    typed ShutdownError — nothing silent; post-drain submits reject."""
    d, probe, _ = _save_model(tmp_path)
    base = _factory(d)
    cfg = serving.ServingConfig(
        n_replicas=1, max_batch=2, max_wait_s=0.001,
        default_deadline_s=30.0, queue_capacity=64,
        dispatch_capacity=1)
    srv = serving.InferenceServer(
        lambda i: _SlowPredictor(base(i), 0.2), cfg).start()
    reqs = [srv.submit({"x": probe[:1]}) for _ in range(8)]
    leftovers = srv.stop(drain_timeout=0.3)   # too short for all 8
    outcomes = {"ok": 0, "shutdown": 0}
    for req in reqs:
        try:
            req.result(timeout=5)
            outcomes["ok"] += 1
        except serving.ShutdownError:
            outcomes["shutdown"] += 1
    assert outcomes["shutdown"] == leftovers > 0
    assert outcomes["ok"] + outcomes["shutdown"] == 8
    assert srv.stats()["accounted"]
    with pytest.raises(serving.ShutdownError):
        srv.submit({"x": probe[:1]})


def test_graceful_drain_completes_every_admitted_request(tmp_path):
    """With a sufficient timeout, drain is fully clean: zero typed-
    shutdown answers, all work completed."""
    d, probe, expect = _save_model(tmp_path)
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                max_wait_s=0.002,
                                default_deadline_s=30.0)
    srv = serving.InferenceServer(_factory(d), cfg).start()
    reqs = [srv.submit({"x": probe[:2]}) for _ in range(12)]
    assert srv.stop() == 0                    # clean drain
    for req in reqs:
        out, = req.result(timeout=1)
        np.testing.assert_allclose(out, expect[:2], rtol=RTOL, atol=ATOL)
    c = srv.stats()["admission"]
    assert c["answered_ok"] == 12 and c["answered_shutdown"] == 0


# ---------------------------------------------------------------------------
# fault-plan teardown must not leak into a flag-off run
# ---------------------------------------------------------------------------

def test_fault_plan_teardown_does_not_leak_into_next_run(tmp_path,
                                                         monkeypatch):
    """A plan installed during a serving run is fully torn down: the
    next run sees zero faults — no requeues, no dead replicas, all-ok
    accounting.  Covers the programmatic and the env installation."""
    monkeypatch.delenv("PADDLE_TPU_FAULT_PLAN", raising=False)
    d, probe, _ = _save_model(tmp_path)
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                max_wait_s=0.002,
                                default_deadline_s=30.0,
                                restart_dead=False)
    plan = FaultPlan().on("serving_infer", 0, "kill")
    with faultinject.installed(plan) as inj:
        srv = serving.InferenceServer(_factory(d), cfg).start()
        for _ in range(4):
            srv.infer({"x": probe[:1]}, timeout=30)
        srv.stop()
        assert inj.log                       # the plan really fired
    assert faultinject.maybe_injector() is None
    monkeypatch.setenv("PADDLE_TPU_FAULT_PLAN", "serving_infer@0:kill")
    assert faultinject.maybe_injector() is not None
    monkeypatch.delenv("PADDLE_TPU_FAULT_PLAN")
    assert faultinject.maybe_injector() is None
    srv2 = serving.InferenceServer(_factory(d), cfg).start()
    for _ in range(4):
        srv2.infer({"x": probe[:1]}, timeout=30)
    assert srv2.stop() == 0
    st = srv2.stats()
    assert st["pool"]["requeues"] == 0
    assert st["pool"]["batches_failed"] == 0
    assert srv2.pool.live_replicas() == [0, 1]
    assert st["admission"]["answered_ok"] == 4


# ---------------------------------------------------------------------------
# health-probe interval knob + pool observability
# ---------------------------------------------------------------------------

def test_health_interval_env_knob_consumed_by_pool(tmp_path,
                                                   monkeypatch):
    """PADDLE_TPU_HEALTH_INTERVAL drives the pool's probe cadence, read
    through the port's copy of distributed.rpc.health_probe_interval,
    which agrees with the JAX package's."""
    from paddle_tpu.distributed.rpc import \
        health_probe_interval as jax_interval

    from paddle_tpu_torch.distributed.rpc import health_probe_interval

    monkeypatch.setenv("PADDLE_TPU_HEALTH_INTERVAL", "0.02")
    assert health_probe_interval() == jax_interval() == 0.02
    monkeypatch.setenv("PADDLE_TPU_HEALTH_INTERVAL", "")
    assert health_probe_interval(3.0) == jax_interval(3.0) == 3.0
    monkeypatch.setenv("PADDLE_TPU_HEALTH_INTERVAL", "0.02")
    d, _, _ = _save_model(tmp_path)
    pool = serving.ReplicaPool(_factory(d), n_replicas=1).start()
    try:
        assert pool._health_interval == 0.02
        t_end = time.monotonic() + 10.0
        while pool.counters()["probes"] < 3 and \
                time.monotonic() < t_end:
            time.sleep(0.01)
        st = pool.stats()
        assert st["probes"] >= 3              # probing at the env rate
        rep = st["replicas"][0]
        assert rep["alive"] and rep["last_health_age_s"] < 1.0
        assert "breaker" in rep               # breaker state visible
        assert st["mesh"] is None
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# mesh-sliced serving: not ported, typed
# ---------------------------------------------------------------------------

def test_replicate_predictor_params_raises_typed(tmp_path):
    """The JAX package places the weights replicated over a device mesh
    (NamedSharding); the port has no mesh yet and says which ROADMAP
    item it waits for, as do the other mesh options."""
    d, _, _ = _save_model(tmp_path)
    p = _predictor(d)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        serving.replicate_predictor_params(p)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        p.shard(None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        p.sharding_info()
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        serving.ServingConfig(mesh_plan=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        serving.ServingConfig(devices=["cuda:0"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        serving.ReplicaPool(_factory(d), n_replicas=1, mesh_plan=object())
    pool = serving.ReplicaPool(_factory(d), n_replicas=1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        pool.mesh_stats()


def test_exporter_and_collector_raise_typed(monkeypatch):
    """``collector`` and ``metrics_port``, given or from the env, are
    taken as the JAX package takes them (the exporter itself:
    tests/test_torch_export.py; the pusher: tests/test_torch_collector.
    py); unset, nothing changes and nothing raises."""
    from paddle_tpu.serving import ServingConfig as JaxServingConfig

    monkeypatch.delenv("PADDLE_TPU_METRICS_PORT", raising=False)
    monkeypatch.delenv("PADDLE_TPU_COLLECTOR", raising=False)
    cfg = serving.ServingConfig()
    assert cfg.metrics_port is None and cfg.collector is None
    assert serving.ServingConfig(metrics_port=0).metrics_port == 0
    assert serving.ServingConfig(collector="localhost:1").collector == \
        JaxServingConfig(collector="localhost:1").collector == "localhost:1"
    monkeypatch.setenv("PADDLE_TPU_METRICS_PORT", "0")
    assert serving.ServingConfig().metrics_port == 0
    monkeypatch.delenv("PADDLE_TPU_METRICS_PORT")
    monkeypatch.setenv("PADDLE_TPU_COLLECTOR", "localhost:1")
    assert serving.ServingConfig().collector == \
        JaxServingConfig().collector == "localhost:1"
    monkeypatch.setenv("PADDLE_TPU_COLLECTOR", "")
    assert serving.ServingConfig().collector is None


def test_serving_config_knobs_and_defaults_match_the_jax_package(
        monkeypatch):
    """Every knob the two packages share has the same default and is
    read the same way from the env."""
    import paddle_tpu.serving as jax_serving

    for var in ("PADDLE_TPU_SERVING_PREWARM", "PADDLE_TPU_COMPILE_CACHE_DIR",
                "PADDLE_TPU_METRICS_PORT", "PADDLE_TPU_COLLECTOR"):
        monkeypatch.delenv(var, raising=False)
    names = ("max_batch", "buckets", "max_wait_s", "queue_capacity",
             "default_deadline_s", "n_replicas", "dispatch_capacity",
             "breaker_threshold", "breaker_cooldown_s",
             "health_interval_s", "restart_dead", "max_batch_attempts",
             "drain_timeout_s", "prewarm", "metrics_port", "trace_sample",
             "collector", "quotas", "health_failures")
    for kw in ({}, dict(max_batch=12, n_replicas=3), dict(max_batch=3)):
        j, p = jax_serving.ServingConfig(**kw), serving.ServingConfig(**kw)
        assert {n: getattr(p, n) for n in names} == \
            {n: getattr(j, n) for n in names}
    monkeypatch.setenv("PADDLE_TPU_SERVING_PREWARM", "1")
    assert serving.ServingConfig().prewarm is True
    monkeypatch.setenv("PADDLE_TPU_SERVING_PREWARM", "off")
    assert serving.ServingConfig().prewarm is False
    with pytest.raises(ValueError):
        serving.ServingConfig(trace_sample=2.0)


# ---------------------------------------------------------------------------
# the slice as a whole: a tiny LM saved by the JAX package, served
# ---------------------------------------------------------------------------

def test_tiny_lm_served_by_two_replicas_matches_the_jax_predictor(
        tmp_path):
    """A 2-layer, d64, 4-head, vocab-512, seq-32 LM saved by the JAX
    package, served by the port's server with 2 replicas (the
    flash-attention op through its plain version, on the CPU): every
    request's logits within 1e-4 of the JAX Predictor's on the same
    rows, every request answered once, one compiled entry a bucket."""
    model = jax_lm(**LM)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(0)
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "lm")
    fluid.io.save_inference_model(d, ["src_ids"], [model["logits"]], exe)
    rng = np.random.RandomState(3)
    rows = [int(r) for r in rng.randint(1, 4, 12)]
    ids = [rng.randint(0, LM["vocab_size"], (r, LM["max_len"], 1))
           .astype(np.int64) for r in rows]
    jpred = jax_inference.create_predictor(jax_inference.Config(d))
    cfg = serving.ServingConfig(n_replicas=2, max_batch=4,
                                max_wait_s=0.005, default_deadline_s=60.0,
                                prewarm=True)
    with serving.InferenceServer(_factory(d), cfg) as srv:
        reqs = [srv.submit({"src_ids": x}) for x in ids]
        outs = [r.result(timeout=60)[0] for r in reqs]
        st = srv.stats()
        entries = [len(r.predictor._compiled._cache)
                   for r in srv.pool.replicas]
    for x, out in zip(ids, outs):
        want, = jpred.run([x])
        assert out.shape == (len(x), LM["max_len"], LM["vocab_size"])
        np.testing.assert_allclose(out, np.asarray(want), rtol=LM_TOL,
                                   atol=LM_TOL)
    assert st["accounted"] and st["admission"]["answered_ok"] == len(ids)
    assert st["batcher"]["real_rows"] == sum(rows)
    assert entries == [len(cfg.buckets)] * 2       # prewarmed, no more


# ---------------------------------------------------------------------------
# the compiled path's per-device lock (two replicas on one card)
# ---------------------------------------------------------------------------

def test_device_lock_orders_captures_against_replays():
    """Every CompiledProgram on one device shares one lock: warm-ups and
    captures hold it one at a time, and runs of cached keys never wait
    for it.  Stressed with more threads than cores and a short switch
    interval: no two captures ever overlap, the runs go on while a
    capture holds the lock (the runs the test saw end inside capture
    windows, and the lock's own count of them), and every capture gets
    in while the runs loop."""
    import sys
    import threading

    import torch

    from paddle_tpu_torch.core import compiler

    lock = compiler._device_lock(torch.device("cuda", 0))
    assert lock is compiler._device_lock(torch.device("cuda", 0))
    assert lock is not compiler._device_lock(torch.device("cuda", 1))
    assert compiler._device_lock(torch.device("cpu")) is compiler._NoLock

    lock = compiler._DeviceLock()
    state = {"capturing": 0, "bad": 0, "captures": 0, "runs": 0,
             "runs_in_captures": 0}
    guard = threading.Lock()
    stop = threading.Event()

    def runner():
        while not stop.is_set():
            with lock.run():
                time.sleep(0.0002)
            with guard:
                state["runs"] += 1
                state["runs_in_captures"] += state["capturing"] > 0

    def capturer():
        for _ in range(20):
            with lock.capture():
                with guard:
                    state["bad"] += state["capturing"] > 0
                    state["capturing"] += 1
                time.sleep(0.002)
                with guard:
                    state["capturing"] -= 1
                    state["captures"] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runners = [threading.Thread(target=runner, daemon=True)
                   for _ in range(12)]
        capturers = [threading.Thread(target=capturer, daemon=True)
                     for _ in range(3)]
        for th in runners + capturers:
            th.start()
        for th in capturers:
            th.join(timeout=30)
        stop.set()
        for th in runners:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in runners + capturers)
    assert state["captures"] == 60 and state["bad"] == 0
    assert state["runs_in_captures"] > 0
    assert len(lock.captures) == 60
    assert sum(n for _, n in lock.captures) > 0
    assert all(s > 0 for s, _ in lock.captures)
