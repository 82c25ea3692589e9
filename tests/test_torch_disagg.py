"""The port's disaggregated prefill/decode tiers
(``DecodeConfig(disagg_prefill=True)``, paddle_tpu_torch/serving/
decode_engine.py) on the CPU, against the JAX package's DecodeServer.

The model is TinyDecodeLM at vocab 128, d_model 64, 4 heads of 16, from
the same seed in both packages.  Prompts are made with numpy from a seed.
The six contracts of the JAX package's disaggregated tests
(tests/test_sharded_serving.py) hold on the port: the flag off is the
single-tier engine, the tiers emit the single tier's tokens with the
handoff moving a page list only, ``spec_k`` is refused, a prefill kill
between the detach and the offer and a decode kill after the adoption
answer every request once with the fault-free tokens and leak nothing,
a deadline expires across the tier boundary, and lost handoffs end in
the typed HandoffError.  The port's disaggregated tokens equal the JAX
package's (``kv_share`` on and off), and seeded chaos runs in the shape
of ``tools/chaos_soak.py``'s ``run_disagg_iteration`` pass its checks.
Every ``result()`` has a timeout.
"""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np
import pytest
import torch_port_helpers  # noqa: F401  (caps torch's threads)

from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.faultinject import FaultPlan
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability.export import parse_prometheus_text

WAIT_S = 60.0

_PROMPTS = [np.array([3, 4, 5], np.int64), np.array([7, 8], np.int64),
            np.array([9, 10, 11, 12, 13], np.int64)]


def _cfg(**kw):
    cfg = dict(max_batch=4, n_replicas=1, max_new_tokens=8,
               default_deadline_s=60.0)
    cfg.update(kw)
    return cfg


def _server(**kw):
    return serving.DecodeServer(config=serving.DecodeConfig(
        device="cpu", **_cfg(**kw))).start()


def _decode_all(srv, prompts):
    reqs = [srv.submit(p, deadline_s=WAIT_S) for p in prompts]
    return [list(r.result(timeout=WAIT_S)[0]) for r in reqs]


def _served(prompts, **kw):
    srv = _server(**kw)
    try:
        outs = _decode_all(srv, prompts)
    finally:
        srv.stop()
    return outs, srv


def _jax_served(prompts, **kw):
    from paddle_tpu import serving as jserving

    srv = jserving.DecodeServer(
        config=jserving.DecodeConfig(**_cfg(**kw))).start()
    try:
        reqs = [srv.submit(p, deadline_s=WAIT_S) for p in prompts]
        return [[int(t) for t in r.result(timeout=WAIT_S)[0]]
                for r in reqs]
    finally:
        srv.stop()


def _assert_drained(srv):
    ok, detail = srv.page_accounting()
    assert ok, detail
    sc = srv._shared_cache
    assert sc.in_use_pages() == 0 and sc.in_transit_pages() == 0
    assert srv.stats()["accounted"]


@pytest.fixture(scope="module")
def single_tier():
    return _served(_PROMPTS)[0]


@pytest.fixture(scope="module")
def seeded_prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(2, 128, size=int(rng.randint(1, 40)))
            for _ in range(8)]


# ---------------------------------------------------------------------------
# the JAX package's six contracts
# ---------------------------------------------------------------------------

def test_disagg_flag_off_is_single_tier():
    srv = _server()
    try:
        assert srv.prefill_replicas == []
        assert srv._shared_cache is None
        assert srv.stats()["disagg"] is None
        assert srv.replicas[0].owns_cache
    finally:
        srv.stop()


def test_disagg_config_on_the_cpu():
    """The flag and the knob resolve as the JAX package's do; the
    collector still raises, naming its ROADMAP item."""
    from paddle_tpu_torch.flags import set_flags

    cfg = serving.DecodeConfig(device="cpu", disagg_prefill=True)
    assert cfg.disagg_prefill and cfg.n_prefill_replicas == 1
    set_flags({"disagg_prefill": True})
    try:
        assert serving.DecodeConfig(device="cpu").disagg_prefill
    finally:
        set_flags({"disagg_prefill": False})
    assert not serving.DecodeConfig(device="cpu").disagg_prefill
    with pytest.raises(ValueError, match="n_prefill_replicas"):
        serving.DecodeConfig(device="cpu", disagg_prefill=True,
                             n_prefill_replicas=0)
    with pytest.raises(NotImplementedError, match="item 4.3"):
        serving.DecodeConfig(device="cpu", disagg_prefill=True,
                             collector="localhost:1")


def test_disagg_outputs_token_identical_and_zero_copy(single_tier):
    """The tiers emit the single tier's tokens; the handoff moves a page
    list only (the shared pool's tensors are the same storage for the
    whole run, and every replica reads that one pool), and the shared
    pool drains to zero."""
    srv = _server(n_replicas=2, disagg_prefill=True, n_prefill_replicas=2)
    sc = srv._shared_cache
    ptrs = (sc.k_pages.data_ptr(), sc.v_pages.data_ptr())
    try:
        assert all(r.cache is sc and not r.owns_cache
                   for r in srv.replicas)
        outs = _decode_all(srv, _PROMPTS)
        st = srv.stats()
        assert st["disagg"]["handoffs_offered"] >= 3
        assert st["disagg"]["handoffs_adopted"] >= 3
        ok, detail = srv.page_accounting()
        assert ok, detail
    finally:
        srv.stop()
    assert outs == single_tier
    assert (sc.k_pages.data_ptr(), sc.v_pages.data_ptr()) == ptrs
    _assert_drained(srv)


def test_disagg_rejects_spec_k():
    with pytest.raises(ValueError):
        serving.DecodeConfig(device="cpu", disagg_prefill=True, spec_k=2)


def _handoff_series():
    snap = obs_metrics.registry().snapshot()
    by = {s["labels"]["outcome"]: s["value"]
          for s in snap["paddle_tpu_disagg_handoffs_total"]["series"]}
    count = sum(s["count"] for s in
                snap["paddle_tpu_disagg_handoff_seconds"]["series"])
    return by, count


def test_disagg_kill_prefill_mid_handoff(single_tier):
    """A prefill replica killed after its pages are allocated and before
    the decode tier adopts them: pages released, the sequence
    re-prefilled on the surviving prefill replica, every request answered
    once with the fault-free tokens, no page leaked; the handoff counter
    and histogram carry the run."""
    before, count0 = _handoff_series()
    srv = _server(disagg_prefill=True, n_prefill_replicas=2,
                  restart_dead=False)
    plan = FaultPlan().on("serving_prefill", 0, "kill")
    try:
        with faultinject.installed(plan):
            outs = _decode_all(srv, _PROMPTS)
        st = srv.stats()
        assert st["disagg"]["prefill_kills"] == 1
        assert st["decode"]["failovers"] >= 1     # the re-prefill
        assert st["accounted"]
        assert sum(p["alive"] for p in
                   st["disagg"]["prefill_replicas"].values()) == 1
        by, count = _handoff_series()
        assert by.get("adopted", 0) - before.get("adopted", 0) >= 3
        assert by.get("killed", 0) - before.get("killed", 0) == 1
        assert count - count0 >= 3
    finally:
        srv.stop()
    assert outs == single_tier
    _assert_drained(srv)


def test_disagg_kill_decode_after_adoption(single_tier):
    """A decode replica killed right after adopting a handoff: its slots
    freed on the shared pool (no reset of the other tier's pages), its
    sequences re-prefilled from token history, every request answered
    once with the fault-free tokens, no page leaked."""
    srv = _server(n_replicas=2, disagg_prefill=True, n_prefill_replicas=1,
                  restart_dead=False)
    plan = FaultPlan().on("serving_decode", 1, "kill")
    try:
        with faultinject.installed(plan):
            outs = _decode_all(srv, _PROMPTS)
        st = srv.stats()
        assert st["decode"]["kills"] == 1
        assert st["accounted"]
        ok, detail = srv.page_accounting()
        assert ok, detail
    finally:
        srv.stop()
    assert outs == single_tier
    _assert_drained(srv)


def test_disagg_decode_kill_frees_only_its_slots():
    """The shared-pool kill path: the dead replica's sequences leave the
    pool, another holder's pages (a handoff in transit) stay."""
    srv = serving.DecodeServer(config=serving.DecodeConfig(
        device="cpu", **_cfg(n_replicas=2, disagg_prefill=True)))
    sc = srv._shared_cache
    dead, other = srv.replicas
    with sc.lock:
        parked = sc.detach(sc.alloc(20))
    seq = serving.decode_engine._Seq(serving.Request(
        0, {"ids": np.arange(2, 8)}, 1, time.monotonic() + WAIT_S),
        np.arange(2, 8), 4)
    seq.slot = sc.alloc(6)
    dead.active.append(seq)
    srv._fail_over(dead)
    assert not dead.alive and other.alive and seq.slot is None
    assert sc.in_use_pages() == sc.in_transit_pages() == len(
        parked["pages"])
    assert srv._retry.qsize() == 1
    with sc.lock:
        sc.release_in_transit(parked)
    assert sc.in_use_pages() == 0 and sc.check_accounting()[0]


def test_disagg_deadline_propagates_across_tiers():
    """A handoff whose request expires in transit (a seeded delay on the
    prefill side) is released at adoption: pages freed, the request
    answered with the typed expiry."""
    srv = _server(disagg_prefill=True)
    plan = FaultPlan().on("serving_prefill", 0, "delay=0.4")
    try:
        with faultinject.installed(plan):
            req = srv.submit(np.array([3, 4, 5], np.int64),
                             deadline_s=0.15)
            with pytest.raises(serving.DeadlineExpiredError,
                               match="handoff"):
                req.result(timeout=30.0)
        st = srv.stats()
        assert st["disagg"]["handoffs_expired"] == 1
        assert st["accounted"]
        ok, detail = srv.page_accounting()
        assert ok, detail
    finally:
        srv.stop()
    _assert_drained(srv)


def test_disagg_typed_handoff_exhaustion():
    """Every handoff lost (a drop on every prefill) spends the attempt
    budget and ends in the typed HandoffError; exactly-once holds."""
    srv = _server(disagg_prefill=True, max_attempts=2)
    plan = FaultPlan()
    for i in range(16):
        plan.on("serving_prefill", i, "drop")
    try:
        with faultinject.installed(plan):
            req = srv.submit(np.array([3, 4], np.int64), deadline_s=30.0)
            with pytest.raises(serving.HandoffError) as ei:
                req.result(timeout=30.0)
            assert ei.value.code == "handoff"
        st = srv.stats()
        assert st["disagg"]["handoffs_lost"] >= 2
        assert st["accounted"]
    finally:
        srv.stop()
    _assert_drained(srv)


def test_disagg_stop_releases_queued_handoffs():
    """Handoffs offered but never adopted (the decode tier made to adopt
    nothing) are released by stop(): the drain answers their requests
    with ShutdownError and the pool holds nothing afterwards."""
    srv = serving.DecodeServer(config=serving.DecodeConfig(
        device="cpu", **_cfg(disagg_prefill=True)))
    srv._admit = lambda rep: None           # this instance adopts nothing
    srv.start()
    try:
        reqs = [srv.submit(p, deadline_s=WAIT_S) for p in _PROMPTS]
        t_end = time.monotonic() + WAIT_S
        while srv._handoff_q.qsize() < len(_PROMPTS):
            assert time.monotonic() < t_end, "the prefill tier stalled"
            time.sleep(0.005)
        assert srv._shared_cache.in_transit_pages() > 0
    finally:
        leftovers = srv.stop(drain_timeout=0.05)
    assert leftovers == len(_PROMPTS)
    for r in reqs:
        with pytest.raises(serving.ShutdownError):
            r.result(timeout=1.0)
    _assert_drained(srv)


def test_disagg_stats_block_and_exported_instruments():
    """stats()["disagg"] has the JAX package's keys, and the /metrics
    exporter shows the four tier instruments."""
    srv = _server(n_replicas=2, disagg_prefill=True, n_prefill_replicas=2,
                  metrics_port=0)
    try:
        _decode_all(srv, _PROMPTS)
        text = urllib.request.urlopen(srv.metrics_server.url + "/metrics",
                                      timeout=5).read().decode()
        st = srv.stats()
    finally:
        srv.stop()
    dis = st["disagg"]
    assert set(dis) == {
        "prefill_replicas", "handoff_queue", "handoffs_offered",
        "handoffs_adopted", "handoffs_lost", "handoffs_expired",
        "prefill_kills", "in_transit_pages", "shared_pool"}
    assert set(dis["prefill_replicas"]) == {0, 1}
    assert sum(p["handoffs"] for p in dis["prefill_replicas"].values()) \
        == dis["handoffs_offered"] == dis["handoffs_adopted"] == 3
    json.dumps(dis)
    names = {n for n, _, _ in parse_prometheus_text(text)}
    for want in ("paddle_tpu_disagg_handoffs_total",
                 "paddle_tpu_disagg_handoff_seconds_count",
                 "paddle_tpu_disagg_tier_replicas",
                 "paddle_tpu_disagg_pages"):
        assert want in names, want
    tiers = {tuple(sorted(l.items())): v
             for n, l, v in parse_prometheus_text(text)
             if n == "paddle_tpu_disagg_tier_replicas"}
    assert tiers[(("tier", "prefill"),)] == 2
    assert tiers[(("tier", "decode"),)] == 2


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_disagg_tokens_equal_the_jax_package(seeded_prompts):
    """The port's disaggregated tokens equal the JAX package's
    disaggregated and single-tier tokens on the same seed and prompts."""
    tiers = dict(n_replicas=2, max_batch=4, disagg_prefill=True,
                 n_prefill_replicas=2, max_new_tokens=10, page_size=16,
                 num_pages=60)
    port, srv = _served(seeded_prompts, **tiers)
    _assert_drained(srv)
    jax_tiers = _jax_served(seeded_prompts, **tiers)
    jax_single = _jax_served(seeded_prompts, **dict(
        tiers, disagg_prefill=False, n_prefill_replicas=1))
    port = [[int(t) for t in o] for o in port]
    assert port == jax_tiers == jax_single


def test_disagg_kv_share_tokens_equal_the_jax_package():
    """A ``kv_share`` disaggregated run over prompts behind one shared
    prefix: the port's tokens equal the JAX package's, and the prefill
    tier shared pages."""
    rng = np.random.RandomState(3)
    prefix = rng.randint(2, 128, size=40)
    prompts = [np.concatenate([prefix, rng.randint(
        2, 128, size=int(rng.randint(1, 12)))]) for _ in range(6)]
    tiers = dict(n_replicas=2, max_batch=4, disagg_prefill=True,
                 n_prefill_replicas=1, kv_share=True, page_size=16,
                 num_pages=60, max_new_tokens=8)
    srv = _server(**tiers)
    try:
        outs = _decode_all(srv, prompts)
        shared = srv._shared_cache._peak_shared
    finally:
        srv.stop()
    _assert_drained(srv)
    assert shared > 0
    jax_outs = _jax_served(prompts, **tiers)
    assert [[int(t) for t in o] for o in outs] == jax_outs


def _chaos_iteration(seed, rate=0.15, max_faults=6, timeout=60.0,
                     n_requests=24):
    """One faulted disaggregated run in the shape of
    ``tools/chaos_soak.py``'s ``run_disagg_iteration``: a seeded random
    plan over ``serving_prefill`` and ``serving_decode`` plus the two
    pinned kills (a prefill replica between the detach and the offer, a
    decode replica after adopting); its checks, as that function makes
    them."""
    plan = FaultPlan(seed=seed, rate=rate,
                     actions=("kill", "close", "drop", "delay=0.02",
                              "delay=0.01+drop"),
                     max_faults=max_faults)
    plan.on("serving_prefill", 1, "kill")
    plan.on("serving_decode", 2, "kill")
    rng = np.random.RandomState(seed)
    shared_prefix = rng.randint(2, 128, size=18)
    deadline = time.monotonic() + timeout
    with faultinject.installed(plan) as inj:
        srv = serving.DecodeServer(config=serving.DecodeConfig(
            device="cpu", max_batch=4, max_new_tokens=8, page_size=16,
            num_pages=96, n_replicas=2, default_deadline_s=60.0,
            restart_dead=True, kv_share=True, disagg_prefill=True,
            n_prefill_replicas=2)).start()
        try:
            futures, rejected = [], 0
            for _ in range(n_requests):
                prompt = rng.randint(2, 128, size=int(rng.randint(1, 12)))
                if rng.rand() < 0.5:
                    prompt = np.concatenate([shared_prefix, prompt])
                try:
                    futures.append(srv.submit(prompt))
                except serving.ServingError:
                    rejected += 1
                time.sleep(0.002)
            answered = 0
            for f in futures:
                try:
                    f.result(timeout=max(0.1, deadline - time.monotonic()))
                except serving.ServingError:
                    pass      # a typed answer: answered, counted
                answered += 1
        finally:
            srv.stop()
        n_faults = len(inj.log)
    st = srv.stats()
    c, dis = st["admission"], st["disagg"]
    assert answered == len(futures)
    assert rejected + c["admitted"] == n_requests
    assert st["accounted"] and not st["outstanding"]
    _assert_drained(srv)
    assert c["answered_ok"] > 0
    assert dis["prefill_kills"] >= 1, dis
    assert dis["handoffs_adopted"] > 0, dis
    assert st["decode"]["failovers"] or dis["handoffs_lost"], dis
    return n_faults


@pytest.mark.parametrize("seed", [0, 1])
def test_disagg_seeded_chaos_run(seed):
    assert _chaos_iteration(seed) >= 2     # the two pinned kills at least
