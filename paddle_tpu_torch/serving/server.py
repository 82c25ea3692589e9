"""The continuous-batching inference server.

Counterpart of ``paddle_tpu/serving/server.py``.  The server runs where
its Predictors run: ``inference.Config`` puts them on the card unless
``disable_gpu()`` is called, and every replica of one server shares
that card.  ``metrics_port`` (or ``PADDLE_TPU_METRICS_PORT``) mounts the
``/metrics`` exporter (``observability/export.py``) from ``start()`` to
``stop()``, and ``collector`` (or ``PADDLE_TPU_COLLECTOR``) runs a fleet
``CollectorPusher`` over the same span (``observability/collector.py``).
Mesh slices (``mesh_plan``, ``devices``) raise ``NotImplementedError``
(ROADMAP Queue 1 item 5.2).

Pipeline: submit() -> AdmissionController (bounded queue, typed
shedding) -> ShapeBucketBatcher (pad-to-bucket, max-wait timer) ->
ReplicaPool dispatch (health/breakers/failover) -> Request future
answered exactly once.

Robustness contract (asserted by tests/test_serving.py, and over the
port by tests/test_torch_serving.py):

  - every ADMITTED request is answered exactly once — a result, or a
    typed ServingError (expired / failed / shutdown); never a silent
    drop (request-id accounting in AdmissionController);
  - over capacity or past deadline, requests are REJECTED with a typed
    error at submit() — overload degrades into typed shedding while
    admitted-request latency stays within the deadline;
  - a replica dying mid-batch requeues the batch onto survivors
    transparently (ReplicaPool failover);
  - drain() completes every admitted request (or answers it with the
    typed ShutdownError) before the server exits.
"""

from __future__ import annotations

import os
import time

import numpy as np

from paddle_tpu_torch.concurrency import Supervisor
from paddle_tpu_torch.observability import tracing as _trace
from paddle_tpu_torch.observability.collector import (CollectorPusher,
                                                      collector_endpoint)
from paddle_tpu_torch.observability.export import (MetricsHTTPServer,
                                                   metrics_port_from_env)
from paddle_tpu_torch.serving.admission import (AdmissionController,
                                                ReplicaFailedError,
                                                ShutdownError, TenantQuota)
from paddle_tpu_torch.serving.batcher import ShapeBucketBatcher, \
    default_buckets
from paddle_tpu_torch.serving.replica_pool import ReplicaPool

__all__ = ["ServingConfig", "InferenceServer"]

_NOT_PORTED = ("{} is not ported yet: it waits for ROADMAP Queue 1 item "
               "{}")
_MESH = "5.2 (the serving tier's mesh options)"


class ServingConfig:
    """Server knobs (mirrors the env-knob table in docs/SERVING.md)."""

    def __init__(self, max_batch=8, buckets=None, max_wait_s=0.005,
                 queue_capacity=None, default_deadline_s=1.0,
                 n_replicas=2, dispatch_capacity=None,
                 breaker_threshold=3, breaker_cooldown_s=0.5,
                 health_interval_s=None, restart_dead=True,
                 max_batch_attempts=None, drain_timeout_s=30.0,
                 prewarm=None, metrics_port=None, trace_sample=None,
                 collector=None, quotas=None, health_failures=None,
                 mesh_plan=None, devices=None):
        self.max_batch = int(max_batch)
        self.buckets = tuple(buckets) if buckets is not None \
            else default_buckets(self.max_batch)
        self.max_wait_s = float(max_wait_s)
        # capacity defaults scale with the batch so a full pipeline is
        # ~2 batches deep per stage — bounded work-in-progress is what
        # keeps admitted-request latency under the deadline
        self.queue_capacity = int(queue_capacity) \
            if queue_capacity is not None else 4 * self.max_batch
        self.default_deadline_s = float(default_deadline_s)
        # mesh-sliced serving: each replica tp-sharded across a slice
        if mesh_plan is not None or devices is not None:
            raise NotImplementedError(_NOT_PORTED.format(
                "ServingConfig(mesh_plan=..., devices=...): mesh-sliced "
                "serving", _MESH))
        if n_replicas is None:
            n_replicas = 2
        self.n_replicas = None if n_replicas is None \
            else int(n_replicas)
        _eff_reps = self.n_replicas if self.n_replicas is not None \
            else 2
        self.dispatch_capacity = int(dispatch_capacity) \
            if dispatch_capacity is not None else 2 * _eff_reps
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.health_interval_s = health_interval_s
        self.restart_dead = bool(restart_dead)
        self.max_batch_attempts = max_batch_attempts
        self.drain_timeout_s = float(drain_timeout_s)
        # cold start: warm up and capture every (replica, bucket)
        # entry at start() so the first real request never pays it.
        # The default is the JAX package's, "prewarm iff the compile
        # cache dir is set" (the port keeps no such cache: a capture
        # lives in its process); PADDLE_TPU_SERVING_PREWARM=0/1
        # overrides.
        if prewarm is None:
            env = os.environ.get("PADDLE_TPU_SERVING_PREWARM")
            if env is not None:
                prewarm = env.lower() in ("1", "true", "yes", "on")
            else:
                prewarm = bool(
                    os.environ.get("PADDLE_TPU_COMPILE_CACHE_DIR"))
        self.prewarm = bool(prewarm)
        # mount /metrics + /varz on this server.  None ->
        # PADDLE_TPU_METRICS_PORT -> off; 0 binds an ephemeral port (read
        # server.metrics_server.port)
        if metrics_port is None:
            metrics_port = metrics_port_from_env(None)
        self.metrics_port = None if metrics_port is None \
            else int(metrics_port)
        # head-based trace sampling: None defers to the
        # tracer's own rate (PADDLE_TPU_TRACE_SAMPLE); a float in
        # [0.0, 1.0] is applied at start() — 0.0 uninstalls the tracer
        # (cost- and wire-identical to the flag being off)
        if trace_sample is not None:
            trace_sample = float(trace_sample)
            if not 0.0 <= trace_sample <= 1.0:
                raise ValueError("trace_sample must be in [0.0, 1.0]")
        self.trace_sample = trace_sample
        # fleet collector: the endpoint the server's pusher targets.
        # None -> PADDLE_TPU_COLLECTOR -> off
        if collector is None:
            collector = collector_endpoint()
        self.collector = collector
        # multi-tenant fleet: per-tenant admission quotas
        # ({tenant: TenantQuota | {max_outstanding/qps/burst/weight}
        # dict}) and the probe-flake tolerance K (docs/FLEET.md)
        if quotas:
            quotas = {t: (q if isinstance(q, TenantQuota)
                          else TenantQuota(**q))
                      for t, q in quotas.items()}
        self.quotas = quotas or None
        self.health_failures = health_failures


class InferenceServer:
    """Continuous-batching server over N predictor replicas.

    predictor_factory(i) -> inference.Predictor for replica i (e.g.
    ``lambda i: inference.create_predictor(inference.Config(d))``).
    """

    def __init__(self, predictor_factory, config=None):
        self.config = cfg = config or ServingConfig()
        self.admission = AdmissionController(
            capacity=cfg.queue_capacity,
            default_deadline_s=cfg.default_deadline_s,
            quotas=cfg.quotas)
        self.pool = ReplicaPool(
            predictor_factory, n_replicas=cfg.n_replicas,
            dispatch_capacity=cfg.dispatch_capacity,
            breaker_threshold=cfg.breaker_threshold,
            breaker_cooldown_s=cfg.breaker_cooldown_s,
            health_interval_s=cfg.health_interval_s,
            restart_dead=cfg.restart_dead,
            max_batch_attempts=cfg.max_batch_attempts,
            health_failures=cfg.health_failures)
        # the registry version currently serving (set by the fleet's
        # RolloutController; None for a single anonymous model)
        self.model_version = None
        self.batcher = ShapeBucketBatcher(
            self.admission, self.pool.dispatch, buckets=cfg.buckets,
            max_wait_s=cfg.max_wait_s)
        self._sup = Supervisor(restart_backoff=0.02, max_backoff=0.5)
        self._sup.add_worker(
            "batcher",
            lambda: self.batcher.run_loop(lambda: self._sup.running),
            restart=True)
        self._validator = self.pool.replicas[0].predictor \
            if self.pool.replicas else None
        self.metrics_server = None
        self.collector_pusher = None
        self._started = False
        self._stopped = False

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._started:
            return self
        self._started = True
        if self.config.trace_sample is not None:
            _trace.set_sample_rate(self.config.trace_sample)
        if self.config.metrics_port is not None:
            try:
                self.metrics_server = MetricsHTTPServer(
                    port=self.config.metrics_port).start()
            except OSError:
                self.metrics_server = None   # scrape endpoint is an
                #                              optimization, not a crash
        if self.config.collector:
            # fleet collector push loop: snapshot + span batches + dump
            # refs on a timer; a dead collector costs one short-deadline
            # failure per tick, never the server
            self.collector_pusher = CollectorPusher(
                self.config.collector, role="serving").start()
        self.pool.start()
        if self.config.prewarm:
            self.prewarm_buckets()
        self._sup.start()
        return self

    def prewarm_buckets(self):
        """Run a zeros batch of every bucket size through every
        replica's predictor, so the full serving bucket set is warmed
        up and captured BEFORE the first request arrives — the
        replica-start half of the cold-start story (docs/SERVING.md).
        Returns the number of (replica, bucket) entries warmed."""

        n = 0
        for rep in self.pool.replicas:
            specs = rep.predictor.feed_specs()
            for b in self.config.buckets:
                feeds = [np.zeros((int(b),) + tuple(
                    int(d) for d in shape[1:]), dtype=dtype)
                    for shape, dtype in specs.values()]
                rep.predictor.run(feeds)
                n += 1
        return n

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request path -------------------------------------------------------
    def submit(self, feeds, deadline_s=None, request_id=None,
               tenant=None):
        """Admit a request; returns a Request future.  Raises a typed
        ServingError synchronously when the request is NOT admitted
        (overloaded / expired / shutdown / over tenant quota / no live
        replicas) and FeedValidationError when the feeds don't match
        the program's feed targets (a malformed request must never
        poison a batch).  ``tenant`` keys quota enforcement and
        weighted-fair dequeue (docs/FLEET.md).

        When tracing is on, this is the ROOT span of the request's
        trace (``serving.submit``): admission / batch / replica /
        predictor / delivery spans all carry its trace id."""
        if _trace._tracer is not None:
            with _trace._tracer.span("serving.submit",
                                     request_id=request_id):
                return self._submit_inner(feeds, deadline_s,
                                          request_id, tenant)
        return self._submit_inner(feeds, deadline_s, request_id,
                                  tenant)

    def _submit_inner(self, feeds, deadline_s, request_id, tenant):
        if not self._started or self._stopped:
            self.admission._count("rejected_shutdown")
            raise ShutdownError("server not running")
        if not self.pool.live_replicas():
            # graceful degradation: with every replica down, reject
            # typed-and-fast instead of admitting work nobody can run
            self.admission._count("rejected_overloaded")
            raise ReplicaFailedError("no live replicas")
        if self._validator is not None:
            feeds = self._validator.validate_feeds(feeds)
        return self.admission.submit(feeds, deadline_s=deadline_s,
                                     request_id=request_id,
                                     tenant=tenant)

    def infer(self, feeds, deadline_s=None, timeout=None,
              tenant=None):
        """Synchronous convenience: submit + result."""
        req = self.submit(feeds, deadline_s=deadline_s, tenant=tenant)
        return req.result(timeout=timeout)

    def set_quota(self, tenant, quota):
        """Install/replace/remove (None) a tenant quota at runtime."""
        self.admission.set_quota(tenant, quota)

    # -- shutdown -----------------------------------------------------------
    def drain(self, timeout=None):
        """Graceful shutdown of the request path: stop admitting, then
        wait for every admitted request to be answered; whatever is
        still unanswered at the timeout is answered with the typed
        ShutdownError.  Returns the number of requests that had to be
        shutdown-failed (0 = fully clean drain)."""
        timeout = self.config.drain_timeout_s if timeout is None \
            else float(timeout)
        self.admission.start_drain()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.admission.outstanding_count() == 0 and \
                    self.pool.idle():
                break
            time.sleep(0.005)
        leftovers = self.admission.outstanding()
        for req in leftovers.values():
            req.fail(ShutdownError(
                f"request {req.id}: server drained before completion"))
        return len(leftovers)

    def stop(self, drain_timeout=None):
        """drain() then tear the workers down."""
        if self._stopped:
            return 0
        leftovers = self.drain(timeout=drain_timeout)
        self._stopped = True
        self._sup.stop(join_timeout=2.0)
        self.pool.stop(join_timeout=2.0)
        if self.collector_pusher is not None:
            # final push so the drain's last spans/counters land
            self.collector_pusher.stop(final_push=True)
            self.collector_pusher = None
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        return leftovers

    # -- observability ------------------------------------------------------
    def stats(self):
        """One dict the load generator / soak serializes: admission
        counters + batcher + pool state."""
        c = self.admission.counters()
        answered = sum(v for k, v in c.items()
                       if k.startswith("answered_"))
        return {
            "admission": c,
            "outstanding": self.admission.outstanding_count(),
            "answered": answered,
            "accounted": answered + self.admission.outstanding_count()
            == c["admitted"],
            "batcher": self.batcher.stats(),
            "pool": self.pool.stats(),
            "tenants": self.admission.tenant_counters(),
            "model_version": None if self.model_version is None
            else str(self.model_version),
            "draining": self.admission.draining,
        }
