"""Request-scoped structured tracing: spans with trace-id/span-id
propagation, chrome-trace export, default-off behind the typed flag
``tracing``.

Propagation contract (docs/OBSERVABILITY.md):

  - a serving request carries ONE trace id from
    ``InferenceServer.submit`` -> admission -> batch formation ->
    replica -> ``Predictor.run`` -> delivery (span ctx rides on the
    ``Request``/``Batch`` objects across the worker threads);
  - the decode path spans join -> step -> retire per sequence;
  - the id rides the RPC envelope (``rpc.py`` wraps the payload as
    ``("__trace__", trace_id, span_id, payload)``) so a pserver-side
    handler span joins the CLIENT's trace.

Disabled-cost contract (the faultinject discipline): every span site
is ONE conditional —

    from paddle_tpu_torch.observability import tracing as _trace
    ...
    if _trace._tracer is not None:
        with _trace._tracer.span("stage", parent=ctx):
            ...work...
    else:
        ...work...

``_tracer`` is a plain module global (None unless tracing is on), so a
flag-off site costs one attribute load + ``is not None``; the bench
test in tests/test_observability.py asserts no measurable per-call
regression vs a build with the sites compiled out.

Export is chrome-trace JSON (``ph: "X"`` duration events, ts/dur in
microseconds) compatible with the existing ``tools/timeline.py``
multi-worker merge; ``paddle_tpu/profiler.py`` is a Fluid-shaped shim
over this module.

Head-based sampling (the Dapper shape): the sampling
decision is made ONCE, at trace-id creation, as a deterministic hash
of the id — ``sha256(trace_id) / 2^64 < rate`` — so every span of a
trace (children, cross-thread stages, the RPC-enveloped server side)
recomputes the SAME decision from the id it inherited: a trace is
never half-sampled, and two processes at the same rate agree without
carrying the decision on the wire.  Unsampled spans still propagate
ctx (parenting stays correct) but record nothing and send NO RPC
envelope; per-path sampled/dropped root counters land in the metrics
registry (``paddle_tpu_trace_traces_total``).  Rate 0.0 does not
install the tracer at all — cost- and wire-identical to flag-off
(the disabled-cost contract extends to it).  Rate 1.0 is bit-identical
to unsampled tracing.  ``PADDLE_TPU_TRACE_SEED`` makes trace-id
generation itself deterministic, so two runs with the same seed sample
the same ids (replayable production sampling).

Env knobs: ``PADDLE_TPU_TRACING=1`` turns the flag on at import;
``PADDLE_TPU_TRACE_CAPACITY`` bounds the finished-span ring (default
65536 spans — tracing memory is bounded no matter how long the
process runs); ``PADDLE_TPU_TRACE_SAMPLE`` in [0.0, 1.0] (default
1.0) is the head-sampling rate; ``PADDLE_TPU_TRACE_SEED`` seeds the
trace-id stream.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import random
import threading
import time
import uuid

from paddle_tpu_torch.observability import metrics as _metrics

__all__ = [
    "Span", "Tracer", "start_tracing", "stop_tracing", "maybe_tracer",
    "enabled", "current", "span", "export_chrome_trace",
    "sample_rate", "set_sample_rate", "sampled", "span_to_dict",
]

# per-path (root span name) sampled/dropped counters — the
# observability of the sampler itself.  sampled + dropped == offered
# root creations at any rate (asserted by the 5c smoke).
_M_TRACES = _metrics.counter(
    "paddle_tpu_trace_traces_total",
    "trace roots by path (root span name) and head-sampling decision",
    max_series=256)

# THE module global every span site checks (one load + None test).
_tracer = None
_tls = threading.local()


def _env_int(name, default):
    v = os.environ.get(name)
    return default if not v else int(v)


def _env_float(name, default):
    v = os.environ.get(name)
    return default if not v else float(v)


def _resolve_sample(sample):
    """Explicit arg wins; else PADDLE_TPU_TRACE_SAMPLE; else 1.0."""
    if sample is None:
        sample = _env_float("PADDLE_TPU_TRACE_SAMPLE", 1.0)
    sample = float(sample)
    if not 0.0 <= sample <= 1.0:
        raise ValueError(
            "trace sample rate must be in [0.0, 1.0], got %r" % sample)
    return sample


def _hash01(trace_id):
    """Deterministic [0, 1) hash of a trace id — THE sampling decision
    function (docs/OBSERVABILITY.md sampling determinism contract):
    any holder of the id recomputes the same decision, in any process,
    in any run."""
    h = hashlib.sha256(trace_id.encode("ascii", "replace")).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class Span:
    """One timed span.  Use as a context manager (activates on the
    thread-local stack so nested sites pick it up as parent) or call
    ``end()`` manually (cross-thread stages that can't nest)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0_ns",
                 "t1_ns", "attrs", "thread", "sampled", "_tracer",
                 "_active")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 attrs, sampled=True):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.thread = threading.get_ident()
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns = None
        self.sampled = sampled
        self._tracer = tracer
        self._active = False

    @property
    def ctx(self):
        """The (trace_id, span_id) pair children parent on — also what
        rides the RPC envelope and the serving Request objects."""
        return (self.trace_id, self.span_id)

    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    def end(self):
        if self.t1_ns is None:
            self.t1_ns = time.perf_counter_ns()
            if self.sampled:   # dropped traces record NOTHING: no
                #                partial traces exist at any rate
                self._tracer._record(self)
        return self

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.ctx)
        self._active = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._active:
            self._active = False
            stack = getattr(_tls, "stack", None)
            if stack and stack[-1] == self.ctx:
                stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False


class Tracer:
    """Span factory + bounded ring of finished spans.

    ``sample`` in [0.0, 1.0] is the head-sampling rate (default: the
    ``PADDLE_TPU_TRACE_SAMPLE`` env knob, else 1.0).  ``seed`` (default
    ``PADDLE_TPU_TRACE_SEED``) makes the trace-id stream deterministic
    so two runs with the same seed sample the same ids."""

    def __init__(self, capacity=None, sample=None, seed=None):
        self.capacity = capacity if capacity is not None else \
            _env_int("PADDLE_TPU_TRACE_CAPACITY", 65536)
        self._ring = [None] * int(self.capacity)
        self._idx = itertools.count()
        self._count = 0          # highest slot written + 1 (read path)
        self._sid = itertools.count(1)
        self.dropped = 0
        self.sample_rate = _resolve_sample(sample)
        if seed is None:
            env_seed = os.environ.get("PADDLE_TPU_TRACE_SEED")
            seed = int(env_seed) if env_seed else None
        self._rng = random.Random(seed) if seed is not None else None
        self.sampled_roots = 0
        self.dropped_roots = 0

    # -- creation -----------------------------------------------------------
    def _new_trace_id(self):
        if self._rng is not None:
            return "%016x" % self._rng.getrandbits(64)
        return uuid.uuid4().hex[:16]

    def _head_sampled(self, trace_id):
        """The head-sampling decision for a trace id — deterministic,
        so children/servers holding only the id reach the same answer
        (the inheritance contract)."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return _hash01(trace_id) < self.sample_rate

    def _ids(self, parent):
        if parent is None:
            parent = current()
        if isinstance(parent, Span):
            parent = parent.ctx
        if parent is not None:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = self._new_trace_id(), None
        return trace_id, "%x" % next(self._sid), parent_id

    def start_span(self, name, parent=None, **attrs):
        """A running span; caller must ``end()`` it (or use ``span``)."""
        trace_id, span_id, parent_id = self._ids(parent)
        sampled = self._head_sampled(trace_id)
        if parent_id is None:
            # per-path sampled/dropped accounting at ROOT creation —
            # the decision point (head-based: decided once per trace)
            if sampled:
                self.sampled_roots += 1
            else:
                self.dropped_roots += 1
            if self.sample_rate < 1.0:
                _M_TRACES.inc(path=name,
                              decision="sampled" if sampled
                              else "dropped")
        return Span(self, name, trace_id, span_id, parent_id, attrs,
                    sampled=sampled)

    def span(self, name, parent=None, **attrs):
        """Context-manager form: activates on the thread-local stack so
        nested sites parent onto it automatically."""
        return self.start_span(name, parent=parent, **attrs)

    def instant(self, name, parent=None, **attrs):
        """Zero-ish-duration span recorded immediately (stage markers
        like batch formation / token retire)."""
        return self.start_span(name, parent=parent, **attrs).end()

    # -- collection ---------------------------------------------------------
    def _record(self, span):
        i = next(self._idx)
        if i >= self.capacity:
            self.dropped += 1
        self._ring[i % self.capacity] = span
        if i + 1 > self._count:
            self._count = i + 1

    def spans(self):
        """Finished spans, oldest first (bounded by capacity)."""
        n = self._count
        out = []
        if n > self.capacity:
            for j in range(n % self.capacity, self.capacity):
                s = self._ring[j]
                if s is not None:
                    out.append(s)
        for j in range(n % self.capacity):
            s = self._ring[j]
            if s is not None:
                out.append(s)
        return out

    def spans_for(self, trace_id):
        return [s for s in self.spans() if s.trace_id == trace_id]

    def spans_since(self, cursor):
        """(finished spans with index >= cursor, new cursor) — the
        collector pusher's incremental read.  Spans that
        fell off the bounded ring before being read are simply gone
        (the ring is the memory bound; the collector marks the process
        stale rather than blocking it)."""
        n = self._count
        if cursor >= n:
            return [], cursor
        out = []
        for i in range(max(cursor, n - self.capacity), n):
            s = self._ring[i % self.capacity]
            if s is not None and s.t1_ns is not None:
                out.append(s)
        return out, n

    def trace_ids(self):
        return sorted({s.trace_id for s in self.spans()})

    def clear(self):
        self._ring = [None] * int(self.capacity)
        self._idx = itertools.count()
        self._count = 0
        self.dropped = 0

    # -- export -------------------------------------------------------------
    def chrome_events(self):
        """Chrome-trace duration events (the tools/timeline.py input
        shape: name/ph/ts/dur/pid/tid + args carrying the trace ids)."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            args.update(s.attrs)
            events.append({
                "name": s.name, "ph": "X",
                "ts": s.t0_ns / 1e3,
                "dur": ((s.t1_ns or s.t0_ns) - s.t0_ns) / 1e3,
                "pid": pid, "tid": s.thread, "args": args,
            })
        return events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events()}, f)
        return path


# -- module-level switch ----------------------------------------------------

def start_tracing(capacity=None, sample=None, seed=None):
    """Install the process tracer (idempotent); returns it.

    ``sample`` is the head-sampling rate (default: the
    ``PADDLE_TPU_TRACE_SAMPLE`` env knob, else 1.0).  Rate 0.0 installs
    NOTHING and returns None — every span site stays at the
    one-conditional disabled cost and the RPC wire carries no trace
    envelope, identical to the flag being off (the
    sample=0.0 contract)."""
    global _tracer
    rate = _resolve_sample(sample)
    if rate <= 0.0:
        _tracer = None
        return None
    if _tracer is None:
        _tracer = Tracer(capacity=capacity, sample=rate, seed=seed)
    else:
        _tracer.sample_rate = rate
    return _tracer


def stop_tracing():
    """Uninstall; returns the (now inert, still readable) tracer."""
    global _tracer
    t = _tracer
    _tracer = None
    return t


def maybe_tracer():
    """None unless tracing is on — the same shape as
    faultinject.maybe_injector().  Hot sites read the ``_tracer``
    module global directly (one conditional, the disabled-cost
    contract)."""
    return _tracer


def enabled():
    return _tracer is not None


def sample_rate():
    """The installed tracer's head-sampling rate (0.0 when tracing is
    off — rate 0.0 and flag-off are the same state by construction)."""
    t = _tracer
    return 0.0 if t is None else t.sample_rate


def set_sample_rate(rate):
    """Change the head-sampling rate of the running tracer
    (``ServingConfig.trace_sample`` lands here at server start).  Rate
    0.0 uninstalls the tracer — back to the one-conditional disabled
    cost; raising it from 0.0 re-installs only if the ``tracing`` flag
    ever started one (a no-op otherwise: the flag owns on/off, the
    rate owns how much).  Returns the tracer or None."""
    global _tracer
    rate = _resolve_sample(float(rate))
    if rate <= 0.0:
        _tracer = None
        return None
    if _tracer is not None:
        _tracer.sample_rate = rate
    return _tracer


def sampled(trace_id):
    """The deterministic decision for ``trace_id`` under the current
    tracer (False when tracing is off)."""
    t = _tracer
    return False if t is None else t._head_sampled(trace_id)


def current():
    """The active (trace_id, span_id) on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def span(name, parent=None, **attrs):
    """Null-safe convenience for NON-hot sites: a real span when
    tracing is on, a no-op context manager when off.  Hot sites use the
    ``_tracer is not None`` guard instead (see the module docstring)."""
    t = _tracer
    return _NULL_SPAN if t is None else t.span(name, parent=parent,
                                               **attrs)


def export_chrome_trace(path):
    t = _tracer
    if t is None:
        raise RuntimeError("tracing is not enabled")
    return t.export_chrome_trace(path)


def span_to_dict(s):
    """Wire/JSON-able form of a finished span — the shape the fleet
    collector stores and tools/tail_forensics.py decomposes
    (docs/OBSERVABILITY.md).  Times are microseconds on this process's
    perf_counter clock (comparable WITHIN a process only)."""
    return {
        "name": s.name, "trace_id": s.trace_id, "span_id": s.span_id,
        "parent_id": s.parent_id,
        "t0_us": s.t0_ns / 1e3,
        "t1_us": (s.t1_ns if s.t1_ns is not None else s.t0_ns) / 1e3,
        "thread": s.thread,
        "attrs": {k: v for k, v in s.attrs.items()
                  if isinstance(v, (str, int, float, bool))
                  or v is None},
    }


def _exemplar_trace():
    """The metrics exemplar hook: the ACTIVE trace id iff a
    tracer is installed, a span is active on this thread, and the
    trace is SAMPLED — so Histogram exemplars exist exactly when the
    trace's spans do (deterministic under PADDLE_TPU_TRACE_SEED), and
    a dropped trace leaves no exemplar just as it leaves no span."""
    t = _tracer
    if t is None:
        return None
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    tid = stack[-1][0]
    return tid if t._head_sampled(tid) else None


_metrics._exemplar_provider = _exemplar_trace


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _init_from_flag():
    """PADDLE_TPU_TRACING=1 (the typed flag ``tracing``) switches the
    tracer on at import — the always-on-in-this-process mode the CI
    smoke uses."""
    try:
        from paddle_tpu_torch import flags

        if flags.get_flag("tracing"):
            start_tracing()
    except Exception:   # flags not importable yet (bootstrap order)
        pass


_init_from_flag()
