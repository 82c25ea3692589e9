"""Admission control: bounded queue, typed load shedding, per-tenant
quotas with weighted-fair dequeue, and the answered-exactly-once
request future.

Contract (docs/SERVING.md): every request the server ADMITS is answered
exactly once — with a result or with a typed ``ServingError`` — and
every request it does NOT admit is rejected synchronously with a typed
error at submit().  Nothing is ever silently dropped; the counters here
are the request-id accounting the acceptance test audits.

Over capacity, submit() raises ``OverloadedError`` immediately instead
of queueing work the deadline already condemned (the Communicator's
backpressure shape).

Multi-tenancy (docs/FLEET.md): requests may carry a
``tenant`` key.  A tenant with a ``TenantQuota`` is admission-limited
two ways — ``max_outstanding`` (admitted-but-unanswered cap) and a
``qps`` token bucket (rate cap with ``burst`` depth) — and over-quota
submits raise the typed ``QuotaExceededError`` (code ``quota``)
WITHOUT consuming shared queue capacity.  Dequeue is weighted-fair
(virtual-time WFQ over per-tenant lanes, ``TenantQuota.weight``), so
one hot tenant saturating its lane cannot starve the others: under
backlog every tenant drains in proportion to its weight.  Per-tenant
outcomes ride ``paddle_tpu_serving_tenant_requests_total``
{tenant, outcome} (bounded cardinality like every registry instrument).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import tracing as _trace

# process-wide admission instruments.  The per-controller
# counters() dict keeps its exact public shape; these aggregate across
# controllers in the process under the typed ``outcome`` label so one
# /metrics scrape sees every shed.
_M_REQS = _obs_metrics.counter(
    "paddle_tpu_admission_requests_total",
    "admission outcomes by typed code (admitted / rejected_* / "
    "answered_*)")
_M_DEPTH = _obs_metrics.gauge(
    "paddle_tpu_admission_queue_depth",
    "admitted-but-untaken requests (last controller written wins in "
    "multi-server processes)")
_M_OUTSTANDING = _obs_metrics.gauge(
    "paddle_tpu_admission_outstanding",
    "admitted-but-unanswered requests")
_M_REQ_SECONDS = _obs_metrics.histogram(
    "paddle_tpu_serving_request_seconds",
    "admitted-request latency (admission -> answered), by typed "
    "outcome — the p99-vs-deadline SLO reads this (observability/"
    "slo.py serving_latency)", max_series=16)
_M_TENANT = _obs_metrics.counter(
    "paddle_tpu_serving_tenant_requests_total",
    "per-tenant admission outcomes (submitted / admitted / "
    "rejected_quota / rejected_overloaded / answered_*) — recorded "
    "only for requests that carry a tenant key; cardinality bounded "
    "at max_series like every registry instrument (docs/FLEET.md)",
    max_series=128)

__all__ = [
    "ServingError", "OverloadedError", "DeadlineExpiredError",
    "ShutdownError", "ReplicaFailedError", "QuotaExceededError",
    "HandoffError", "TenantQuota", "Request", "AdmissionController",
]


class ServingError(RuntimeError):
    """Base of every typed non-success reply.  ``code`` is the stable
    machine-readable reason (the load generator and soak key on it)."""

    code = "error"


class OverloadedError(ServingError):
    """Rejected at admission: queue at capacity (load shed)."""

    code = "overloaded"


class DeadlineExpiredError(ServingError):
    """The request's deadline passed — shed at admission, before batch
    formation, or before result delivery (compute may or may not have
    happened; the reply is typed either way)."""

    code = "expired"


class ShutdownError(ServingError):
    """The server is draining / stopped; the request was answered with
    this instead of being silently abandoned."""

    code = "shutdown"


class ReplicaFailedError(ServingError):
    """No replica could run the batch (all dead / breaker-open /
    failover attempts exhausted)."""

    code = "failed"


class HandoffError(ServingError):
    """The prefill->decode page-list handoff failed terminally
   : the transfer was lost/aborted more times than the
    retry budget allows, or adoption found the handle gone.  A lost
    handoff normally re-prefills transparently; this code surfaces
    only when that fallback is exhausted — exactly-once still holds
    (the reply is this typed error, never silence)."""

    code = "handoff"


class QuotaExceededError(ServingError):
    """Rejected at admission: the request's TENANT is over its quota
    (max outstanding, or the QPS token bucket is empty).  A quota shed
    is policy, not failure — the caller's remedy is backoff, not
    retry-elsewhere — which is why it gets its own typed code instead
    of riding ``overloaded``."""

    code = "quota"


class TenantQuota:
    """Per-tenant admission limits + fair-share weight.

    ``max_outstanding``  cap on admitted-but-unanswered requests
                         (None = unlimited)
    ``qps``              sustained admission rate via a token bucket
                         (None = unlimited); ``burst`` is the bucket
                         depth (default: one second's worth, >= 1)
    ``weight``           weighted-fair dequeue share under backlog
                         (relative; default 1.0)
    """

    __slots__ = ("max_outstanding", "qps", "burst", "weight",
                 "_tokens", "_refill_t", "_lock")

    def __init__(self, max_outstanding=None, qps=None, burst=None,
                 weight=1.0):
        self.max_outstanding = None if max_outstanding is None \
            else int(max_outstanding)
        self.qps = None if qps is None else float(qps)
        if self.qps is not None and self.qps <= 0:
            raise ValueError("qps quota must be > 0")
        self.burst = float(burst) if burst is not None \
            else (max(1.0, self.qps) if self.qps is not None else 1.0)
        self.weight = float(weight)
        if self.weight <= 0:
            raise ValueError("weight must be > 0")
        self._tokens = self.burst
        self._refill_t = time.monotonic()
        self._lock = threading.Lock()

    def try_take_token(self, now=None):
        """Consume one admission token; False when the bucket is empty
        (the QPS shed).  No-op True when no qps quota is set."""
        if self.qps is None:
            return True
        now = time.monotonic() if now is None else now
        with self._lock:
            self._tokens = min(
                self.burst,
                self._tokens + (now - self._refill_t) * self.qps)
            self._refill_t = now
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    def to_dict(self):
        return {"max_outstanding": self.max_outstanding,
                "qps": self.qps, "burst": self.burst,
                "weight": self.weight}


class Request:
    """One admitted request: a future answered EXACTLY once.

    ``complete``/``fail`` race-safely deliver the first answer and
    ignore (but count) the rest — a failed-over batch re-computed on a
    second replica can never double-deliver."""

    __slots__ = ("id", "feeds", "rows", "deadline_t", "admitted_t",
                 "_event", "_lock", "_result", "_error", "_on_done",
                 "done_t", "trace", "tenant")

    def __init__(self, req_id, feeds, rows, deadline_t, on_done=None,
                 tenant=None):
        self.id = req_id
        self.feeds = feeds            # {name: ndarray}, shared leading dim
        self.rows = int(rows)         # leading-dim extent
        self.tenant = tenant          # quota/fairness key (None = default)
        self.deadline_t = float(deadline_t)
        self.admitted_t = time.monotonic()
        self.done_t = None
        self.trace = None             # (trace_id, span_id) when tracing
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error = None
        self._on_done = on_done

    def expired(self, now=None):
        return (time.monotonic() if now is None else now) \
            > self.deadline_t

    def remaining(self, now=None):
        return self.deadline_t - (time.monotonic() if now is None
                                  else now)

    def done(self):
        return self._event.is_set()

    def complete(self, result):
        """Deliver a success reply; False if already answered."""
        return self._finish(result, None)

    def fail(self, exc):
        """Deliver a typed error reply; False if already answered."""
        return self._finish(None, exc)

    def _finish(self, result, exc):
        with self._lock:
            if self._event.is_set():
                return False          # exactly-once: first answer wins
            self._result = result
            self._error = exc
            self.done_t = time.monotonic()
            self._event.set()
        if self._on_done is not None:
            self._on_done(self, exc)
        return True

    def result(self, timeout=None):
        """Block for the answer; returns the output list or raises the
        typed ServingError the server answered with."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id}: no answer within {timeout}s "
                "(the request is still in flight — this is a caller "
                "wait timeout, not a server reply)")
        if self._error is not None:
            raise self._error
        return self._result

    def latency_s(self):
        return None if self.done_t is None \
            else self.done_t - self.admitted_t


class AdmissionController:
    """Bounded admission queue + typed shedding + per-tenant quotas +
    weighted-fair dequeue + request accounting.

    The queue is per-tenant lanes drained by virtual-time weighted
    fair queuing: each lane carries a virtual finish time advanced by
    1/weight per dequeued request, ``take()`` serves the non-empty
    lane with the smallest virtual time, and a lane going from empty
    to non-empty joins at the scheduler's current virtual clock (no
    banked credit for idle tenants).  With a single (default) lane
    this degenerates to exact FIFO — the pre-fleet behavior."""

    def __init__(self, capacity=64, default_deadline_s=1.0,
                 quotas=None):
        self.capacity = int(capacity)
        self.default_deadline_s = float(default_deadline_s)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._outstanding: dict = {}     # id -> Request (admitted, unanswered)
        self._draining = False
        # WFQ lanes (tenant key None = the default lane "")
        self._lanes: dict = {}           # lane -> deque[Request]
        self._vtime: dict = {}           # lane -> virtual finish time
        self._vclock = 0.0               # virtual time of last service
        self._depth = 0                  # total queued across lanes
        self._not_empty = threading.Condition(self._lock)
        self._quotas: dict = dict(quotas or {})   # tenant -> TenantQuota
        self._tenant_outstanding: dict = {}       # tenant -> count
        self._tenant_counters: dict = {}          # tenant -> {k: n}
        self._counters = {
            "admitted": 0,
            "rejected_overloaded": 0,    # never admitted (typed raise)
            "rejected_expired": 0,
            "rejected_shutdown": 0,
            "rejected_quota": 0,         # tenant over its quota
            "answered_ok": 0,            # admitted -> success
            "answered_expired": 0,       # admitted -> typed error, by code
            "answered_shutdown": 0,
            "answered_failed": 0,
            "answered_error": 0,
        }

    # -- tenant quotas ------------------------------------------------------
    def set_quota(self, tenant, quota):
        """Install/replace (or with None, remove) a tenant's quota —
        takes effect on the next submit."""
        with self._lock:
            if quota is None:
                self._quotas.pop(tenant, None)
            else:
                self._quotas[tenant] = quota

    def quotas(self):
        with self._lock:
            return dict(self._quotas)

    # distinct tenant keys tracked per controller; past the bound new
    # keys aggregate under the overflow key (mirrors the instrument's
    # max_series=128 — high-cardinality / one-shot tenant keys must
    # not grow process memory without bound)
    MAX_TENANT_KEYS = 128
    OVERFLOW_TENANT = "<other>"

    def _tenant_count(self, tenant, key, n=1):
        if tenant is None:
            return
        with self._lock:
            c = self._tenant_counters.get(tenant)
            if c is None:
                if len(self._tenant_counters) >= self.MAX_TENANT_KEYS:
                    tenant = self.OVERFLOW_TENANT
                    c = self._tenant_counters.setdefault(tenant, {})
                else:
                    c = self._tenant_counters[tenant] = {}
            c[key] = c.get(key, 0) + n
        _M_TENANT.inc(n, tenant=str(tenant), outcome=key)

    def tenant_counters(self):
        """Per-tenant outcome counts, {tenant: {outcome: n}} — the
        load generator's per-tenant rows read this."""
        with self._lock:
            return {t: dict(c) for t, c in
                    self._tenant_counters.items()}

    # -- submit side --------------------------------------------------------
    def submit(self, feeds, deadline_s=None, request_id=None,
               tenant=None):
        """Admit a request or raise a typed ServingError.  feeds:
        {name: ndarray} with a shared leading (batch) dim; ``tenant``
        keys quota enforcement and fair dequeue (None = default lane,
        never quota-limited).

        When tracing is on, admission runs under a
        ``serving.admission`` span (child of the caller's
        ``serving.submit`` span) and the admitted Request carries the
        span ctx — the batcher/replica/delivery stages chain onto it
        so ONE trace id covers the request end to end."""
        if _trace._tracer is not None:
            with _trace._tracer.span("serving.admission") as sp:
                req = self._submit_inner(feeds, deadline_s, request_id,
                                         tenant)
                sp.set_attr("request_id", req.id)
                req.trace = sp.ctx
                return req
        return self._submit_inner(feeds, deadline_s, request_id,
                                  tenant)

    def _submit_inner(self, feeds, deadline_s, request_id, tenant):
        self._tenant_count(tenant, "submitted")
        if self._draining:
            self._count("rejected_shutdown")
            raise ShutdownError("server is draining: not admitting")
        deadline_s = self.default_deadline_s if deadline_s is None \
            else float(deadline_s)
        now = time.monotonic()
        if deadline_s <= 0:
            self._count("rejected_expired")
            raise DeadlineExpiredError(
                f"deadline {deadline_s:g}s already expired at submit")
        quota = self._quotas.get(tenant) if tenant is not None \
            else None
        reserved = False
        if quota is not None and quota.max_outstanding is not None:
            # quota sheds happen BEFORE capacity is consumed: an
            # over-quota tenant cannot displace in-quota traffic.  The
            # check RESERVES the outstanding slot in the same locked
            # section, so concurrent submits for one tenant cannot all
            # pass the check and exceed the cap; any later rejection
            # on this path releases the reservation.
            with self._lock:
                held = self._tenant_outstanding.get(tenant, 0)
                if held < quota.max_outstanding:
                    self._tenant_outstanding[tenant] = held + 1
                    reserved = True
            if not reserved:
                self._count("rejected_quota")
                self._tenant_count(tenant, "rejected_quota")
                raise QuotaExceededError(
                    f"tenant '{tenant}' at max_outstanding "
                    f"{quota.max_outstanding}: quota shed")
        try:
            if quota is not None and not quota.try_take_token(now):
                self._count("rejected_quota")
                self._tenant_count(tenant, "rejected_quota")
                raise QuotaExceededError(
                    f"tenant '{tenant}' QPS token bucket empty "
                    f"(qps {quota.qps:g}): quota shed")
            rows = None
            for name, arr in feeds.items():
                arr = np.asarray(arr)
                n = arr.shape[0] if arr.ndim else 1
                if rows is None:
                    rows = n
                elif n != rows:
                    raise ValueError(
                        f"feed '{name}' leading dim {n} != {rows} "
                        "(all feeds of one request share the batch "
                        "dim)")
            if not rows:
                raise ValueError("request with no feeds / zero rows")
            req = Request(
                request_id if request_id is not None
                else next(self._ids),
                {n: np.asarray(v) for n, v in feeds.items()},
                rows, now + deadline_s, on_done=self._on_done,
                tenant=tenant)
            lane = "" if tenant is None else tenant
            with self._lock:
                if self._depth >= self.capacity:
                    self._counters["rejected_overloaded"] += 1
                    full = True
                else:
                    full = False
                    dq = self._lanes.get(lane)
                    if dq is None:
                        dq = self._lanes[lane] = deque()
                    if not dq:
                        # joining lane starts at the current virtual
                        # clock: idle tenants bank no credit
                        self._vtime[lane] = max(
                            self._vtime.get(lane, 0.0), self._vclock)
                    dq.append(req)
                    self._depth += 1
                    self._outstanding[req.id] = req
                    self._counters["admitted"] += 1
                    if tenant is not None and not reserved:
                        self._tenant_outstanding[tenant] = \
                            self._tenant_outstanding.get(tenant, 0) + 1
                    _M_OUTSTANDING.set(len(self._outstanding))
                    self._not_empty.notify()
            if full:
                _M_REQS.inc(outcome="rejected_overloaded")
                self._tenant_count(tenant, "rejected_overloaded")
                raise OverloadedError(
                    f"admission queue full (capacity "
                    f"{self.capacity}): load shed") from None
        except BaseException:
            if reserved:
                self._release_outstanding(tenant)
            raise
        _M_REQS.inc(outcome="admitted")
        self._tenant_count(tenant, "admitted")
        _M_DEPTH.set(self._depth)
        return req

    def _release_outstanding(self, tenant):
        """Undo a reserved outstanding slot for a submit that was
        rejected after the reservation."""
        with self._lock:
            n = self._tenant_outstanding.get(tenant, 1) - 1
            if n <= 0:
                self._tenant_outstanding.pop(tenant, None)
            else:
                self._tenant_outstanding[tenant] = n

    def _lane_weight(self, lane):
        q = self._quotas.get(lane if lane != "" else None)
        return q.weight if q is not None else 1.0

    def _pop_locked(self):
        """WFQ pop under self._lock; None when every lane is empty."""
        best = None
        for lane, dq in self._lanes.items():
            if dq and (best is None
                       or self._vtime[lane] < self._vtime[best]):
                best = lane
        if best is None:
            return None
        dq = self._lanes[best]
        req = dq.popleft()
        self._depth -= 1
        self._vclock = self._vtime[best]
        if dq:
            self._vtime[best] += 1.0 / self._lane_weight(best)
        else:
            # prune the emptied lane and its virtual time: lane state
            # is bounded by the CURRENT backlog, not by every tenant
            # key ever seen (a rejoining lane re-enters at the virtual
            # clock anyway — idle tenants bank no credit)
            del self._lanes[best]
            self._vtime.pop(best, None)
        return req

    # -- batcher side -------------------------------------------------------
    def take(self, timeout=0.002):
        """Pop the next admitted request — weighted-fair across tenant
        lanes (None on timeout)."""
        deadline = time.monotonic() + float(timeout)
        with self._not_empty:
            while True:
                req = self._pop_locked()
                if req is not None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._not_empty.wait(remaining)
        _M_DEPTH.set(self._depth)
        return req

    def qsize(self):
        with self._lock:
            return self._depth

    # -- drain / accounting -------------------------------------------------
    def start_drain(self):
        """Stop admitting; everything already admitted will still be
        answered (or typed-shutdown by the server's drain sweep)."""
        self._draining = True

    @property
    def draining(self):
        return self._draining

    def outstanding(self):
        """Admitted-but-unanswered requests, id -> Request."""
        with self._lock:
            return dict(self._outstanding)

    def outstanding_count(self):
        with self._lock:
            return len(self._outstanding)

    def counters(self):
        with self._lock:
            return dict(self._counters)

    def _count(self, key, n=1):
        with self._lock:
            self._counters[key] += n
        _M_REQS.inc(n, outcome=key)

    def _on_done(self, req, exc):
        with self._lock:
            self._outstanding.pop(req.id, None)
            if req.tenant is not None:
                n = self._tenant_outstanding.get(req.tenant, 1) - 1
                if n <= 0:
                    self._tenant_outstanding.pop(req.tenant, None)
                else:
                    self._tenant_outstanding[req.tenant] = n
            _M_OUTSTANDING.set(len(self._outstanding))
            if exc is None:
                key = "answered_ok"
            else:
                code = getattr(exc, "code", "error")
                key = "answered_%s" % (
                    code if "answered_%s" % code in self._counters
                    else "error")
            self._counters[key] += 1
        _M_REQS.inc(outcome=key)
        self._tenant_count(req.tenant, key)
        lat = req.latency_s()
        if lat is not None:
            # exemplar: the delivery thread has no span
            # ctx of its own, so the request's trace id is passed
            # explicitly — recorded only when the trace is SAMPLED,
            # so the p99 bucket names a trace that actually has spans
            exemplar = None
            if _trace._tracer is not None and req.trace is not None \
                    and _trace._tracer._head_sampled(req.trace[0]):
                exemplar = req.trace[0]
            _M_REQ_SECONDS.observe(
                lat, exemplar=exemplar,
                outcome="ok" if exc is None
                else getattr(exc, "code", "error"))
        if _trace._tracer is not None and req.trace is not None:
            _trace._tracer.instant(
                "serving.deliver", parent=req.trace,
                request_id=req.id,
                outcome="ok" if exc is None
                else getattr(exc, "code", "error"))
