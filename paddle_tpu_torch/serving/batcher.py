"""Shape-bucketed continuous batching with a compile-once bucket cache.

Counterpart of ``paddle_tpu/serving/batcher.py``.  On the card a bucket
is one ``CompiledProgram`` key: its first batch warms up and captures
the program as CUDA graphs, every later batch of that bucket replays
them.

Requests whose non-batch shapes/dtypes agree (one *signature*) are
concatenated along the leading dim and padded up to a fixed bucket size
before hitting a replica, so the predictor's per-shape compile cache
sees at most ``len(buckets)`` shapes per signature — the compile-once
bucket cache.  A max-wait timer bounds the time a lone request sits
waiting for batch-mates, so p99 stays bounded at low offered load.

Deadline propagation: expired requests are shed (answered with the
typed ``DeadlineExpiredError``) BEFORE batch formation — compute is
never spent building a batch around a reply nobody is waiting for.
The delivery-side shed (a request that expires while its batch is on a
replica) lives in ``Batch.deliver``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics
from paddle_tpu_torch.observability import tracing as _trace
from paddle_tpu_torch.serving.admission import DeadlineExpiredError

__all__ = ["default_buckets", "signature_of", "Batch",
           "ShapeBucketBatcher"]

_M_BATCHES = _obs_metrics.counter(
    "paddle_tpu_batcher_batches_total",
    "formed batches by bucket-cache temperature (cold = first time "
    "this (signature, bucket) was formed)")
_M_ROWS = _obs_metrics.counter(
    "paddle_tpu_batcher_rows_total",
    "rows through the batcher (real vs pad)")
_M_OCCUPANCY = _obs_metrics.histogram(
    "paddle_tpu_batcher_occupancy_ratio",
    "real_rows / bucket per formed batch",
    buckets=tuple(i / 8.0 for i in range(1, 9)))
_M_SHED = _obs_metrics.counter(
    "paddle_tpu_batcher_shed_expired_total",
    "requests shed before batch formation (deadline passed)")


def default_buckets(max_batch):
    """Powers of two up to (and always including) max_batch."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def signature_of(feeds):
    """Batchability key: sorted (name, non-batch shape, dtype)."""
    return tuple(sorted(
        (name, tuple(np.asarray(a).shape[1:]), str(np.asarray(a).dtype))
        for name, a in feeds.items()))


class Batch:
    """A formed (padded) batch plus the requests riding in it."""

    __slots__ = ("requests", "feeds", "rows", "bucket", "signature",
                 "attempts", "trace")

    def __init__(self, requests, feeds, rows, bucket, signature):
        self.requests = list(requests)
        self.feeds = feeds            # {name: padded ndarray}, dim0=bucket
        self.rows = int(rows)         # real rows (<= bucket)
        self.bucket = int(bucket)
        self.signature = signature
        self.attempts = 0             # failover hops so far
        self.trace = None             # oldest rider's span ctx

    def all_expired(self, now=None):
        now = time.monotonic() if now is None else now
        return all(r.expired(now) for r in self.requests)

    def deliver(self, outputs):
        """Slice per-request rows out of the padded outputs and answer
        each request — success, or the typed expired error for a
        request whose deadline passed while the batch computed (the
        before-result-delivery shed)."""
        now = time.monotonic()
        off = 0
        for req in self.requests:
            if req.expired(now):
                req.fail(DeadlineExpiredError(
                    f"request {req.id}: deadline passed during batch "
                    "compute"))
            else:
                req.complete([np.asarray(o)[off:off + req.rows]
                              for o in outputs])
            off += req.rows

    def fail_all(self, exc):
        for req in self.requests:
            req.fail(exc)


class ShapeBucketBatcher:
    """Forms batches from the admission queue; runs as one supervised
    worker loop inside the server."""

    def __init__(self, admission, dispatch, buckets=(1, 2, 4, 8),
                 max_wait_s=0.005):
        self._admission = admission
        self._dispatch = dispatch          # BoundedQueue of Batch
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_batch = self.buckets[-1]
        self.max_wait_s = float(max_wait_s)
        self._pending: dict = {}           # signature -> [Request]
        self._first_t: dict = {}           # signature -> oldest arrival
        self._lock = threading.Lock()
        self._stats = {"batches": 0, "padded_rows": 0, "real_rows": 0,
                       "shed_expired": 0,
                       # bucket-cache temperature: a batch whose
                       # (signature, bucket) was never formed before
                       # is COLD (the replica pays a warm-up and a
                       # capture unless the server prewarmed it); the
                       # rest are WARM
                       "bucket_cold": 0, "bucket_warm": 0}
        self._shapes: set = set()          # (signature, bucket) formed

    # -- stats --------------------------------------------------------------
    def stats(self):
        with self._lock:
            st = dict(self._stats)
        st["bucket_shapes"] = len(self._shapes)
        return st

    def bucket_for(self, rows):
        """Smallest bucket >= rows; an oversized request runs at its
        exact extent (correct, but uncached — keep requests within
        max_batch to stay on the compile-once path)."""
        for b in self.buckets:
            if rows <= b:
                return b
        return int(rows)

    # -- the loop -----------------------------------------------------------
    def run_loop(self, running_fn):
        """Pull/form/dispatch until running_fn() goes false, then flush
        what's pending (drain leaves nothing stranded in the batcher)."""
        poll = max(self.max_wait_s / 2.0, 0.0005)
        while running_fn():
            req = self._admission.take(timeout=poll)
            if req is not None:
                self._add(req)
            self._flush_ready(force=req is None and
                              self._admission.draining)
        self.flush(force=True)

    def _add(self, req):
        now = time.monotonic()
        if req.expired(now):
            # shed BEFORE batch formation: no compute for a reply
            # nobody is waiting for
            self._stats["shed_expired"] += 1
            req.fail(DeadlineExpiredError(
                f"request {req.id}: deadline passed before batch "
                "formation"))
            return
        sig = signature_of(req.feeds)
        self._pending.setdefault(sig, []).append(req)
        self._first_t.setdefault(sig, now)

    def _flush_ready(self, force=False):
        now = time.monotonic()
        for sig in list(self._pending):
            reqs = self._pending[sig]
            rows = sum(r.rows for r in reqs)
            waited = now - self._first_t.get(sig, now)
            # tightest-deadline nearness also forces the flush: a
            # request about to expire must not sit out the max-wait
            tight = reqs and min(r.remaining(now) for r in reqs) \
                <= self.max_wait_s
            if rows >= self.max_batch or waited >= self.max_wait_s \
                    or tight or force:
                self._form(sig)

    def flush(self, force=False):
        """Form batches out of everything pending (drain path)."""
        for sig in list(self._pending):
            if force or self._pending[sig]:
                self._form(sig)

    def _form(self, sig):
        reqs = self._pending.pop(sig, [])
        first_t = self._first_t.pop(sig, None)
        if not reqs:
            return
        now = time.monotonic()
        # the group's formation window (first rider taken -> batch
        # formed): splits a request's admission->batch gap into queue
        # wait and batch formation
        formation_us = int((now - first_t) * 1e6) \
            if first_t is not None else 0
        live = []
        for r in reqs:
            if r.expired(now):
                self._stats["shed_expired"] += 1
                _M_SHED.inc()
                r.fail(DeadlineExpiredError(
                    f"request {r.id}: deadline passed before batch "
                    "formation"))
            else:
                live.append(r)
        # chunk greedily to the max bucket (requests are small; a
        # group can still exceed it when many arrived in one window)
        while live:
            chunk, rows = [], 0
            while live and rows + live[0].rows <= self.max_batch:
                chunk.append(live.pop(0))
                rows += chunk[-1].rows
            if not chunk:     # single request wider than max_batch
                chunk = [live.pop(0)]
                rows = chunk[0].rows
            bucket = self.bucket_for(rows)
            feeds = {}
            for name, _, _ in sig:
                parts = [r.feeds[name] for r in chunk]
                pad = bucket - rows
                if pad > 0:
                    parts.append(np.zeros(
                        (pad,) + tuple(np.asarray(parts[0]).shape[1:]),
                        dtype=np.asarray(parts[0]).dtype))
                feeds[name] = np.concatenate(
                    [np.asarray(p) for p in parts], axis=0) \
                    if len(parts) > 1 else np.asarray(parts[0])
            batch = Batch(chunk, feeds, rows, bucket, sig)
            cold = (sig, bucket) not in self._shapes
            with self._lock:
                self._stats["batches"] += 1
                self._stats["real_rows"] += rows
                self._stats["padded_rows"] += bucket
                self._stats["bucket_cold" if cold
                            else "bucket_warm"] += 1
            self._shapes.add((sig, bucket))
            _M_BATCHES.inc(temperature="cold" if cold else "warm")
            _M_ROWS.inc(rows, kind="real")
            _M_ROWS.inc(bucket - rows, kind="pad")
            _M_OCCUPANCY.observe(rows / float(bucket))
            _flight.record("serving", "batch_formed", rows=rows,
                           bucket=bucket, riders=len(chunk),
                           cold=cold)
            if _trace._tracer is not None:
                # per-rider formation marker chained onto the request
                # trace; the batch itself carries the OLDEST rider's
                # ctx so the replica-stage span joins that trace
                for r in chunk:
                    sp = _trace._tracer.instant(
                        "serving.batch", parent=r.trace,
                        bucket=bucket, rows=rows, request_id=r.id,
                        formation_us=formation_us)
                    if r.trace is not None:
                        r.trace = sp.ctx
                batch.trace = chunk[0].trace
            # blocking put: dispatch backpressure stalls the batcher,
            # which stalls admission takes, which sheds at submit —
            # overload degrades with typed rejections, not queues
            self._dispatch.put(batch, block=True)
