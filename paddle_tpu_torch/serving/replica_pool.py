"""Multi-replica execution: health probes, per-replica circuit
breakers, and automatic failover of in-flight batches.

Counterpart of ``paddle_tpu/serving/replica_pool.py``.  Replicas are N
in-process Predictors (one per supervised worker thread).  On the card
they share it: each has its own CompiledProgram (its own scope, graphs
and graph pool), and the compiled path's per-device lock orders one
replica's warm-up and capture against the other's replays
(``core/compiler.py``).  Mesh slices (``mesh_plan``, ``devices``) and
``replicate_predictor_params`` are not ported (ROADMAP Queue 1 item 5.2).

Every failure mode is driven through ``distributed/faultinject.py``
so it is a seeded, replayable test: replicas consult the installed
plan under msg types ``serving_infer`` (one call per batch execution)
and ``serving_health`` (one per probe).  Action semantics mirror the
wire transports:

  ``kill``       the replica dies mid-batch (worker thread exits); the
                 in-flight batch is requeued to a surviving replica.
  ``close``      transient execution failure BEFORE compute ran.
  ``drop``       compute ran, the reply frame is lost — the batch is
                 requeued; exactly-once delivery is the Request
                 future's job, so the re-computed answer lands once.
  ``delay=S``    the reply is S seconds late (deadline exercise).
  ``truncate``   reply frame corrupt mid-write: treated like drop.

A batch whose run raises anything else (a CUDA error among them) is a
failed batch of that replica: requeued onto another, never rerun on
the CPU.

Health probes run every ``PADDLE_TPU_HEALTH_INTERVAL`` seconds (the
same knob RPC-level probers read — distributed.rpc.
health_probe_interval); a probe failure counts against the replica's
breaker exactly like a batch failure.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time

from paddle_tpu_torch.concurrency import BoundedQueue, Supervisor
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.rpc import health_probe_interval
from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import tracing as _trace
from paddle_tpu_torch.serving.admission import (DeadlineExpiredError,
                                          ReplicaFailedError)

_M_POOL = _obs_metrics.counter(
    "paddle_tpu_replica_pool_events_total",
    "replica-pool transitions (batches_ok / batches_failed / "
    "requeues / probes / probe_failures / shed_expired_batches / "
    "kills), by event")
_M_LIVE = _obs_metrics.gauge(
    "paddle_tpu_replica_pool_live_replicas",
    "replicas currently alive (last pool written wins)")
_M_BATCH_SECONDS = _obs_metrics.histogram(
    "paddle_tpu_replica_batch_seconds",
    "per-batch replica execution wall time")

__all__ = ["MSG_INFER", "MSG_HEALTH", "ReplicaKilled", "ReplyLost",
           "Replica", "ReplicaPool", "replicate_predictor_params"]

_NO_MESH = ("{}: mesh-sliced serving is not ported yet (ROADMAP Queue "
            "1 item 5.2, the serving tier's mesh options)")

MSG_INFER = faultinject.register_msg_type("serving_infer")
MSG_HEALTH = faultinject.register_msg_type("serving_health")


class ReplicaKilled(RuntimeError):
    """The replica process/thread died (injected ``kill``)."""


class ReplyLost(RuntimeError):
    """Transient execution failure; the batch is safe to requeue."""


class Replica:
    """One predictor + liveness/breaker state."""

    def __init__(self, index, predictor, breaker_threshold=3,
                 breaker_cooldown_s=0.5):
        self.index = int(index)
        self.predictor = predictor
        self.alive = True
        self.last_health_t = None
        self.batches = 0
        self.failures = 0
        # fleet state: ``paused`` makes the worker stop
        # taking NEW batches (the per-replica drain the rollout and
        # scale-down ride); ``busy`` is set around batch execution so
        # a quiesce can wait for the in-flight batch; ``retired``
        # permanently ends the worker (scale-down) — never resurrected
        # by restart_dead; ``version`` is the registry tag the rollout
        # controller maintains (None outside fleet serving)
        self.paused = False
        self.busy = False
        self.retired = False
        self.version = None
        self._consec_fails = 0
        self._open_until = 0.0
        self._threshold = int(breaker_threshold)
        self._cooldown = float(breaker_cooldown_s)
        self._lock = threading.Lock()

    # -- breaker (the RPCClient per-endpoint shape, per replica) ------------
    def available(self, now=None):
        """Live and breaker-closed (or half-open: one probe allowed)."""
        if not self.alive:
            return False
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._threshold <= 0 or \
                    self._consec_fails < self._threshold:
                return True
            if now < self._open_until:
                return False
            # half-open: admit this probe, push the window
            self._open_until = now + self._cooldown
            return True

    def breaker_open(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._threshold > 0 and \
                self._consec_fails >= self._threshold and \
                now < self._open_until

    def record_ok(self):
        with self._lock:
            self._consec_fails = 0

    def record_failure(self):
        with self._lock:
            self._consec_fails += 1
            self._open_until = time.monotonic() + self._cooldown
            self.failures += 1

    # -- execution ----------------------------------------------------------
    def run(self, batch):
        """Run one batch through the predictor, consulting the fault
        plan first.  Returns the predictor's output list.

        When tracing is on, execution runs under a ``serving.replica``
        span joined to the batch's (oldest rider's) trace; the nested
        ``predictor.run`` span picks it up from the thread-local
        stack.  Every OTHER rider gets its own sibling
        ``serving.replica`` span covering the same execution window,
        so each request's trace decomposes on its own (without the
        sibling spans only one rider per batch would carry a replica
        stage)."""
        if _trace._tracer is not None:
            tr = _trace._tracer
            extra = [tr.start_span("serving.replica", parent=r.trace,
                                   replica=self.index,
                                   rows=batch.rows,
                                   bucket=batch.bucket,
                                   request_id=r.id)
                     for r in batch.requests
                     if r.trace is not None and r.trace != batch.trace]
            try:
                with tr.span("serving.replica",
                             parent=batch.trace,
                             replica=self.index,
                             rows=batch.rows,
                             bucket=batch.bucket):
                    return self._run_inner(batch)
            finally:
                for sp in extra:
                    sp.end()
        return self._run_inner(batch)

    def _run_inner(self, batch):
        inj = faultinject.maybe_injector()
        steps = []
        if inj is not None:
            act = inj.decide(MSG_INFER)
            if act is not None:
                steps = faultinject.steps_of(act)
        if steps and steps[0][0] in ("close", "kill"):
            if steps[0][0] == "kill":
                self.alive = False
                _flight.record("serving", "replica_killed",
                               replica=self.index,
                               batch_rows=batch.rows)
                raise ReplicaKilled(
                    f"replica {self.index} killed mid-batch "
                    "(fault injection)")
            raise ReplyLost(
                f"replica {self.index}: connection closed before "
                "compute (fault injection)")
        feeds = [batch.feeds[n]
                 for n in self.predictor.get_input_names()]
        outs = self.predictor.run(feeds)
        for kind, arg in steps:
            if kind == "delay":
                time.sleep(arg)
            elif kind in ("drop", "truncate"):
                raise ReplyLost(
                    f"replica {self.index}: reply frame "
                    f"{'lost' if kind == 'drop' else 'corrupt'} "
                    "(fault injection)")
        self.batches += 1
        return outs

    def health(self):
        """Liveness probe (fault-aware; raises on probe failure)."""
        inj = faultinject.maybe_injector()
        if inj is not None:
            act = inj.decide(MSG_HEALTH)
            if act is not None:
                for kind, arg in faultinject.steps_of(act):
                    if kind == "delay":
                        time.sleep(arg)
                    else:
                        raise ReplyLost(
                            f"replica {self.index}: health probe "
                            f"{kind} (fault injection)")
        if not self.alive:
            raise ReplicaKilled(f"replica {self.index} is dead")
        self.last_health_t = time.monotonic()
        return {"status": "ok", "replica": self.index,
                "batches": self.batches}

    def stats(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return {
                "alive": self.alive,
                "paused": self.paused,
                "version": None if self.version is None
                else str(self.version),
                "batches": self.batches,
                "failures": self.failures,
                "breaker": {
                    "consecutive_failures": self._consec_fails,
                    "open": self._threshold > 0 and
                    self._consec_fails >= self._threshold and
                    now < self._open_until,
                    "cooldown_remaining_s":
                        max(0.0, self._open_until - now),
                },
                "last_health_age_s":
                    None if self.last_health_t is None
                    else now - self.last_health_t,
            }


class ReplicaPool:
    """Dispatch queue + N supervised replica workers + health monitor."""

    def __init__(self, predictor_factory, n_replicas=2,
                 dispatch_capacity=8, breaker_threshold=3,
                 breaker_cooldown_s=0.5, health_interval_s=None,
                 restart_dead=True, max_batch_attempts=None,
                 restart_backoff=0.05, health_failures=None,
                 mesh_plan=None, devices=None):
        """predictor_factory(i) -> a Predictor for replica i (each
        replica owns its predictor: private scope + compile cache).
        restart_dead=False leaves a killed replica down — pure
        failover, the acceptance-test mode.  ``health_failures`` is
        the probe-flake tolerance: a replica's breaker only sees a
        probe failure after this many CONSECUTIVE probe failures
        (default PADDLE_TPU_HEALTH_FAILURES or 2 — one seeded delayed
        probe must not kill a healthy replica).

        ``mesh_plan`` and ``devices`` (mesh-sliced replicas) raise
        ``NotImplementedError`` (ROADMAP Queue 1 item 5.2)."""
        import os

        if mesh_plan is not None or devices is not None:
            raise NotImplementedError(_NO_MESH.format(
                "ReplicaPool(mesh_plan=..., devices=...)"))
        self._factory = predictor_factory
        if n_replicas is None:
            n_replicas = 2
        self._restart_dead = bool(restart_dead)
        self._max_attempts = int(max_batch_attempts) \
            if max_batch_attempts is not None else 2 * n_replicas + 1
        self._health_interval = health_probe_interval(1.0) \
            if health_interval_s is None else float(health_interval_s)
        if health_failures is None:
            health_failures = int(os.environ.get(
                "PADDLE_TPU_HEALTH_FAILURES", "2"))
        self._health_failures = max(1, int(health_failures))
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown_s)
        self.dispatch = BoundedQueue(maxsize=dispatch_capacity)
        # failover lane: UNBOUNDED on purpose — a worker must never
        # block requeueing into a full dispatch queue that only itself
        # consumes (single-survivor deadlock).  Total batches in the
        # system stay bounded by the admission queue's capacity, so
        # this lane cannot grow without bound.
        self._retry = BoundedQueue()
        self.replicas = []
        for i in range(int(n_replicas)):
            rep = Replica(i, predictor_factory(i),
                          breaker_threshold=breaker_threshold,
                          breaker_cooldown_s=breaker_cooldown_s)
            self.replicas.append(rep)
        self._next_index = int(n_replicas)
        self._sup = Supervisor(restart_backoff=restart_backoff,
                               max_backoff=1.0)
        for rep in self.replicas:
            self._sup.add_worker("replica-%d" % rep.index,
                                 self._make_worker(rep),
                                 restart=self._restart_dead)
        self._sup.add_worker("health", self._health_loop, restart=True)
        self._lock = threading.Lock()
        self._in_flight = 0
        self._probe_fails: dict = {}   # replica index -> consecutive
        self._counters = {"batches_ok": 0, "batches_failed": 0,
                          "requeues": 0, "probes": 0,
                          "probe_failures": 0, "shed_expired_batches": 0}

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._sup.start()
        return self

    def stop(self, join_timeout=5.0):
        self._sup.stop(join_timeout=join_timeout)

    def errors(self):
        return self._sup.errors()

    def restarts(self):
        return self._sup.restarts()

    # -- batch intake -------------------------------------------------------
    def submit_batch(self, batch, block=True, timeout=None):
        self.dispatch.put(batch, block=block, timeout=timeout)

    def live_replicas(self):
        return [r.index for r in self.replicas if r.alive]

    def in_flight(self):
        with self._lock:
            return self._in_flight

    def idle(self):
        return self.dispatch.empty() and self._retry.empty() \
            and self.in_flight() == 0

    def counters(self):
        with self._lock:
            return dict(self._counters)

    # -- mesh slices: not ported ------------------------------------------
    def mesh_stats(self):
        """Slice-carving summary of a mesh-sliced pool: not ported,
        raises (ROADMAP Queue 1 item 5.2)."""
        raise NotImplementedError(_NO_MESH.format("ReplicaPool.mesh_stats"))

    # -- fleet operations ---------------------------------------------------
    def replica(self, index):
        for r in self.replicas:
            if r.index == index:
                return r
        raise KeyError(f"no replica with index {index}")

    def quiesce_replica(self, index, timeout=10.0):
        """Per-replica drain: stop the replica taking NEW batches and
        wait for its in-flight batch to finish.  Returns the quiesced
        Replica; on timeout the pause is reverted and TimeoutError
        raised (the replica keeps serving — a failed quiesce must not
        half-drain the fleet)."""
        rep = self.replica(index)
        rep.paused = True
        deadline = time.monotonic() + float(timeout)
        while rep.busy:
            if time.monotonic() > deadline:
                rep.paused = False
                raise TimeoutError(
                    f"replica {index}: batch still in flight after "
                    f"{timeout:g}s quiesce")
            time.sleep(0.002)
        return rep

    def resume_replica(self, index):
        self.replica(index).paused = False

    def swap_predictor(self, index, source, version=None,
                       timeout=10.0):
        """The rollout primitive: quiesce replica ``index`` through
        the per-replica drain, hot-swap its predictor onto ``source``
        (a prewarm-compiled Predictor or a ``program_state()``
        snapshot — inference.Predictor.swap_program), tag it with
        ``version``, resume.  Returns (prior_state, prior_version)
        for rollback.  Zero requests are dropped: new batches flow to
        the other replicas while this one drains (or wait in dispatch
        when it is the only one)."""
        rep = self.quiesce_replica(index, timeout=timeout)
        try:
            prior = rep.predictor.swap_program(source)
            prior_version, rep.version = rep.version, version
            self._count(swaps=1)
            _flight.record("fleet", "replica_swapped", replica=index,
                           version=str(version),
                           prior=str(prior_version))
            return prior, prior_version
        finally:
            rep.paused = False

    def set_factory(self, predictor_factory):
        """Replace the predictor factory future ``add_replica`` calls
        build from.  The rollout controller points it at the converged
        registry version so post-rollout scale-ups serve the program
        their ``version`` tag claims."""
        self._factory = predictor_factory

    def add_replica(self, version=None, predictor=None):
        """Scale up: start a new replica worker (fresh index, never
        reused) and return its index.  The predictor comes from, in
        order: ``predictor`` (a prebuilt/prewarmed one), the
        ``version``'s own loader when it has one (a registry
        ModelVersion — the tag must describe the program actually
        served, never a stale factory), else the pool factory."""
        with self._lock:
            idx = self._next_index
            self._next_index += 1
        if predictor is None:
            make = getattr(version, "make_predictor", None)
            predictor = make() if callable(make) else self._factory(idx)
        rep = Replica(idx, predictor,
                      breaker_threshold=self._breaker_threshold,
                      breaker_cooldown_s=self._breaker_cooldown)
        rep.version = version
        self.replicas.append(rep)
        self._sup.add_worker("replica-%d" % idx,
                             self._make_worker(rep),
                             restart=self._restart_dead)
        self._count(scale_ups=1)
        _M_LIVE.set(len(self.live_replicas()))
        _flight.record("fleet", "replica_added", replica=idx,
                       live=len(self.live_replicas()))
        return idx

    def remove_replica(self, index=None, timeout=10.0, force=False):
        """Scale down THROUGH GRACEFUL DRAIN: quiesce the replica
        (its in-flight batch finishes and is delivered), then retire
        it permanently (never resurrected by restart_dead).  Default
        victim: the newest live replica.  Refuses to remove the last
        live replica unless ``force`` — a fleet of zero answers
        nobody."""
        live = [r for r in self.replicas if r.alive and not r.retired]
        if index is None:
            if not live:
                raise RuntimeError("no live replica to remove")
            index = live[-1].index
        if len(live) <= 1 and not force:
            raise RuntimeError(
                "refusing to remove the last live replica "
                "(force=True overrides)")
        rep = self.quiesce_replica(index, timeout=timeout)
        rep.retired = True
        rep.alive = False
        self._sup.remove_worker("replica-%d" % index)
        self.replicas.remove(rep)
        self._count(scale_downs=1)
        _M_LIVE.set(len(self.live_replicas()))
        _flight.record("fleet", "replica_removed", replica=index,
                       live=len(self.live_replicas()))
        return index

    def stats(self):
        now = time.monotonic()
        st = {"replicas": {r.index: r.stats(now)
                           for r in self.replicas},
              "dispatch_depth": self.dispatch.qsize(),
              "retry_depth": self._retry.qsize(),
              "in_flight": self.in_flight(),
              "mesh": None,         # mesh slices are not ported
              "restarts": self.restarts()}
        st.update(self.counters())
        return st

    # -- workers ------------------------------------------------------------
    def _make_worker(self, rep):
        def loop():
            # a supervisor restart of this loop IS the replica relaunch
            # (restart_dead=True); with restart_dead=False the
            # supervisor never respawns it and the replica stays down.
            # A RETIRED replica (scale-down) is never resurrected.
            if rep.retired:
                return
            if not rep.alive and self._restart_dead:
                rep.alive = True
                rep.record_ok()
            while self._sup.running:
                if not rep.alive or rep.retired:
                    return
                if rep.paused:
                    # per-replica drain (rollout swap / scale-down):
                    # stop taking NEW batches; in-flight work was
                    # already counted via rep.busy
                    time.sleep(0.002)
                    continue
                try:                      # failover lane first
                    batch = self._retry.get_nowait()
                except queue_mod.Empty:
                    try:
                        batch = self.dispatch.get(timeout=0.01)
                    except queue_mod.Empty:
                        continue
                # busy is raised BEFORE the paused re-check: a quiesce
                # that sets paused concurrently either sees busy and
                # waits, or set paused early enough that this re-check
                # observes it and requeues — swap_program can never
                # overlap run() (the TOCTOU the old post-take order
                # left open)
                rep.busy = True
                if rep.paused or rep.retired:
                    # pause raced the take: hand the batch on rather
                    # than run it — the quiesce contract is "no NEW
                    # batch starts after pause"
                    rep.busy = False
                    self._retry.put(batch)
                    continue
                if not rep.available():
                    # breaker open: hand the batch to a healthier
                    # replica; brief sleep avoids a requeue spin when
                    # every breaker is open
                    rep.busy = False
                    self._retry.put(batch)
                    time.sleep(0.005)
                    continue
                if batch.all_expired():
                    # every rider's deadline passed while queued: shed
                    # without compute, typed replies
                    rep.busy = False
                    self._count(shed_expired_batches=1)
                    batch.fail_all(DeadlineExpiredError(
                        "batch expired before execution"))
                    continue
                with self._lock:
                    self._in_flight += 1
                t0 = time.perf_counter()
                try:
                    outs = rep.run(batch)
                except ReplicaKilled:
                    rep.record_failure()
                    self._requeue_or_fail(batch)
                    self._count(kills=1)
                    _M_LIVE.set(len(self.live_replicas()))
                    # post-mortem: the ring now holds the chaos action
                    # + the kill + the requeue — dump the narrative
                    _flight.dump(reason="replica_death")
                    raise      # worker dies; supervisor may relaunch
                except Exception:
                    rep.record_failure()
                    self._requeue_or_fail(batch)
                else:
                    rep.record_ok()
                    _M_BATCH_SECONDS.observe(time.perf_counter() - t0)
                    batch.deliver(outs)
                    self._count(batches_ok=1)
                finally:
                    rep.busy = False
                    with self._lock:
                        self._in_flight -= 1

        return loop

    def _requeue_or_fail(self, batch):
        """Failover: push the batch back for another replica, or answer
        every rider with the typed failure when there is nowhere left
        to go (never a silent drop)."""
        batch.attempts += 1
        live = [r for r in self.replicas if r.alive]
        if batch.attempts >= self._max_attempts or not live:
            self._count(batches_failed=1)
            batch.fail_all(ReplicaFailedError(
                f"batch failed after {batch.attempts} attempts; "
                f"{len(live)} live replicas"))
            return
        self._count(requeues=1)
        self._retry.put(batch)         # unbounded lane: never blocks

    def _health_loop(self):
        while self._sup.running:
            for rep in list(self.replicas):
                if not self._sup.running:
                    return
                if not rep.alive or rep.retired:
                    continue
                self._count(probes=1)
                try:
                    rep.health()
                except Exception:
                    # probe-flake tolerance: only
                    # K CONSECUTIVE probe failures reach the breaker —
                    # one seeded delayed/dropped probe must not kill a
                    # healthy replica (PADDLE_TPU_HEALTH_FAILURES)
                    n = self._probe_fails.get(rep.index, 0) + 1
                    self._probe_fails[rep.index] = n
                    self._count(probe_failures=1)
                    if n >= self._health_failures:
                        rep.record_failure()
                    else:
                        self._count(probe_flakes_tolerated=1)
                else:
                    self._probe_fails[rep.index] = 0
            t = time.monotonic() + self._health_interval
            while self._sup.running and time.monotonic() < t:
                time.sleep(min(0.02, self._health_interval))

    def _count(self, **incs):
        with self._lock:
            for k, v in incs.items():
                # 'kills' rides only the registry (the public
                # counters() shape is frozen — docs/SERVING.md)
                if k in self._counters:
                    self._counters[k] += v
        for k, v in incs.items():
            _M_POOL.inc(v, event=k)


def replicate_predictor_params(predictor, mesh=None):
    """Placing a Predictor's parameters replicated over a device mesh (N
    replicas reading one device copy): not ported, raises (ROADMAP Queue
    1 item 5.2)."""
    raise NotImplementedError(_NO_MESH.format("replicate_predictor_params"))
