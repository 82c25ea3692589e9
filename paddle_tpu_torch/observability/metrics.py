"""Process-wide metrics registry: typed, labeled instruments.

One metrics surface for every subsystem instead of the
mutually-incompatible per-module ``stats()`` dicts PRs 3-8 grew:

  - ``Counter``    monotonically increasing (calls, retries, sheds)
  - ``Gauge``      point-in-time value (queue depth, page utilization)
  - ``Histogram``  fixed log-bucket distribution with p50/p95/p99
                   summaries (latencies, batch occupancy)

Contract (docs/OBSERVABILITY.md):

  - instrument names follow the grammar
    ``paddle_tpu_<subsystem>_<noun>[_total|_seconds|_ratio|_depth]``
    (validated: ``^[a-z][a-z0-9_]*$``); label names are prometheus
    label names.
  - label cardinality is BOUNDED per instrument (``max_series``,
    default 64): past the bound, new label combinations collapse into
    one ``{overflow="true"}`` series and ``overflow_dropped`` counts
    them — a label-explosion bug degrades one instrument's resolution,
    never process memory.
  - thread-safe and always-on: the hot path is one cached dict lookup
    plus a per-series lock around a float add (the series handle can be
    bound once and reused: ``c = counter(...).labels(endpoint=ep)`` then
    ``c.inc()``).
  - two exports: ``prometheus_text()`` (text exposition, grammar
    checked in-tree by ``observability.export.parse_prometheus_text``)
    and ``snapshot()`` / ``snapshot_line()`` (one JSON line, embedded
    by tools/serving_load.py and tools/chaos_soak.py results).

The process-wide registry is ``registry()``; module-level
``counter()/gauge()/histogram()`` are get-or-create conveniences on it.
"""

from __future__ import annotations

import bisect
import json
import re
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS", "registry", "counter", "gauge", "histogram",
]

# Exemplar context hook: installed by observability.tracing
# at import — () -> trace_id of the ACTIVE *sampled* trace, else None.
# Histograms record a bounded per-bucket exemplar reservoir only when
# this returns an id, so exemplar presence is exactly head-sampling
# presence (deterministic under PADDLE_TPU_TRACE_SEED) and a run with
# tracing off (or sample 0.0) produces byte-identical exposition.
_exemplar_provider = None

_NAME_RE = re.compile(r"[a-z][a-z0-9_]*\Z")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")

# fixed log buckets (powers of two): ~1 microsecond .. ~128 s covers
# every latency this stack produces; also serviceable for ratios and
# small sizes.  Histograms may pass their own bounds.
DEFAULT_BUCKETS = tuple(2.0 ** e for e in range(-20, 8))

_OVERFLOW_KEY = (("overflow", "true"),)


def _label_key(labels):
    """Canonical hashable key for a label set (sorted (k, str(v)))."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Series:
    """One (instrument, label set) time series."""

    __slots__ = ("labels", "_lock")

    def __init__(self, labels):
        self.labels = dict(labels)
        self._lock = threading.Lock()


class _CounterSeries(_Series):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters only go up (inc(n >= 0))")
        with self._lock:
            self.value += n

    def get(self):
        return self.value


class _GaugeSeries(_Series):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0

    def set(self, v):
        with self._lock:
            self.value = float(v)

    def add(self, n=1):
        with self._lock:
            self.value += n

    def get(self):
        return self.value


class _HistogramSeries(_Series):
    __slots__ = ("bounds", "counts", "sum", "count", "min", "max",
                 "exemplars", "_exemplar_cap")

    def __init__(self, labels, bounds, exemplar_capacity=1):
        super().__init__(labels)
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.min = None
        self.max = None
        # per-bucket exemplar reservoir: bucket index ->
        # [(trace_id, value, unix_ts)], newest-wins ring bounded at
        # exemplar_capacity — total exemplar memory is
        # O(buckets * capacity), never O(observations)
        self.exemplars: dict = {}
        self._exemplar_cap = int(exemplar_capacity)

    def observe(self, v, exemplar=None):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if exemplar is not None and self._exemplar_cap > 0:
                ring = self.exemplars.setdefault(i, [])
                ring.append((str(exemplar), v, time.time()))
                if len(ring) > self._exemplar_cap:
                    ring.pop(0)

    def _bucket_le(self, i):
        """The exposition `le` of bucket index i (+Inf past bounds)."""
        return self.bounds[i] if i < len(self.bounds) else \
            float("inf")

    def exemplar_list(self):
        """[{le, trace_id, value, ts}] snapshot, bucket order."""
        with self._lock:
            items = sorted(self.exemplars.items())
            out = []
            for i, ring in items:
                le = self._bucket_le(i)
                for tid, v, ts in ring:
                    out.append({"le": "+Inf" if le == float("inf")
                                else le, "trace_id": tid,
                                "value": v, "ts": ts})
        return out

    def percentile(self, p):
        """Upper bound of the bucket holding the p-th percentile (the
        log-bucket resolution is the contract: ~2x).  None when empty;
        the +Inf bucket reports the observed max."""
        with self._lock:
            count = self.count
            counts = list(self.counts)
            mx = self.max
        if not count:
            return None
        target = max(1, -(-int(p * count) // 100))   # ceil(p% * count)
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) else mx
        return mx

    def summary(self):
        with self._lock:
            if not self.count:
                return {"count": 0, "sum": 0.0, "min": None,
                        "max": None, "p50": None, "p95": None,
                        "p99": None}
            out = {"count": self.count, "sum": self.sum,
                   "min": self.min, "max": self.max}
        out["p50"] = self.percentile(50)
        out["p95"] = self.percentile(95)
        out["p99"] = self.percentile(99)
        ex = self.exemplar_list()
        if ex:      # only-when-present: an exemplar-free run's
            #         snapshot stays byte-identical to the exemplar-free format
            out["exemplars"] = ex
        return out


class _Instrument:
    """Shared labeled-series machinery; subclasses pin kind/series."""

    kind = None

    def __init__(self, name, help="", max_series=64):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad instrument name {name!r} (grammar: "
                "^[a-z][a-z0-9_]*$; see docs/OBSERVABILITY.md)")
        self.name = name
        self.help = help
        self.max_series = int(max_series)
        self._series: dict = {}
        self._lock = threading.Lock()
        self.overflow_dropped = 0

    def _new_series(self, labels):
        raise NotImplementedError

    def labels(self, **labels):
        """The series handle for this label set (create on first use,
        cached; past max_series the overflow series is returned)."""
        key = _label_key(labels)
        s = self._series.get(key)
        if s is not None:
            return s
        with self._lock:
            s = self._series.get(key)
            if s is not None:
                return s
            for k, _ in key:
                if not _LABEL_RE.match(k):
                    raise ValueError(f"bad label name {k!r}")
            if len(self._series) >= self.max_series:
                self.overflow_dropped += 1
                s = self._series.get(_OVERFLOW_KEY)
                if s is None:
                    s = self._series[_OVERFLOW_KEY] = \
                        self._new_series(dict(_OVERFLOW_KEY))
                return s
            s = self._series[key] = self._new_series(dict(key))
            return s

    def series(self):
        """[(labels_dict, series)] snapshot, stable order."""
        with self._lock:
            items = sorted(self._series.items())
        return [(dict(k), s) for k, s in items]


class Counter(_Instrument):
    kind = "counter"

    def _new_series(self, labels):
        return _CounterSeries(labels)

    def inc(self, n=1, **labels):
        self.labels(**labels).inc(n)

    def value(self, **labels):
        key = _label_key(labels)
        s = self._series.get(key)
        return 0.0 if s is None else s.get()

    def items(self):
        """[(labels_dict, value)] — the view RPCClient.stats() reads."""
        return [(lbl, s.get()) for lbl, s in self.series()]

    def total(self):
        return sum(s.get() for _, s in self.series())


class Gauge(_Instrument):
    kind = "gauge"

    def _new_series(self, labels):
        return _GaugeSeries(labels)

    def set(self, v, **labels):
        self.labels(**labels).set(v)

    def add(self, n=1, **labels):
        self.labels(**labels).add(n)

    def value(self, **labels):
        key = _label_key(labels)
        s = self._series.get(key)
        return 0.0 if s is None else s.get()

    def items(self):
        return [(lbl, s.get()) for lbl, s in self.series()]


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help="", buckets=None, max_series=64,
                 exemplar_capacity=1):
        super().__init__(name, help=help, max_series=max_series)
        b = tuple(float(x) for x in (buckets or DEFAULT_BUCKETS))
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError("histogram buckets must strictly increase")
        self.buckets = b
        self.exemplar_capacity = int(exemplar_capacity)

    def _new_series(self, labels):
        return _HistogramSeries(labels, self.buckets,
                                exemplar_capacity=self.exemplar_capacity)

    def observe(self, v, exemplar=None, **labels):
        """Record one observation.  ``exemplar`` (a trace id) pins a
        per-bucket exemplar; when omitted, the ambient SAMPLED trace id
        (observability.tracing's provider hook) is used — exemplar
        presence is exactly head-sampling presence."""
        if exemplar is None and _exemplar_provider is not None:
            exemplar = _exemplar_provider()
        self.labels(**labels).observe(v, exemplar=exemplar)

    def summary(self, **labels):
        key = _label_key(labels)
        s = self._series.get(key)
        return _HistogramSeries(dict(key), self.buckets).summary() \
            if s is None else s.summary()

    def exemplars(self, **labels):
        """[{le, trace_id, value, ts}] of one series ([] if absent)."""
        key = _label_key(labels)
        s = self._series.get(key)
        return [] if s is None else s.exemplar_list()

    def items(self):
        return [(lbl, s.summary()) for lbl, s in self.series()]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name -> instrument, get-or-create, kind-checked."""

    def __init__(self):
        self._instruments: dict = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"instrument {name!r} already registered as "
                        f"{inst.kind}, requested {cls.kind}")
                return inst
            inst = self._instruments[name] = cls(name, help=help, **kw)
            return inst

    def counter(self, name, help="", max_series=64):
        return self._get_or_create(Counter, name, help,
                                   max_series=max_series)

    def gauge(self, name, help="", max_series=64):
        return self._get_or_create(Gauge, name, help,
                                   max_series=max_series)

    def histogram(self, name, help="", buckets=None, max_series=64,
                  exemplar_capacity=1):
        return self._get_or_create(Histogram, name, help,
                                   buckets=buckets,
                                   max_series=max_series,
                                   exemplar_capacity=exemplar_capacity)

    def get(self, name):
        return self._instruments.get(name)

    def names(self):
        with self._lock:
            return sorted(self._instruments)

    def unregister(self, name):
        """Tests only: forget one instrument."""
        with self._lock:
            self._instruments.pop(name, None)

    # -- exports ------------------------------------------------------------
    def snapshot(self):
        """JSON-able dict: name -> {type, series: [...]}.  Histogram
        series carry the summary (count/sum/min/max/p50/p95/p99), not
        the raw buckets — the one-JSON-line embed stays bounded."""
        out = {}
        for name in self.names():
            inst = self._instruments[name]
            if inst.kind == "histogram":
                series = [{"labels": lbl, **summ}
                          for lbl, summ in inst.items()]
            else:
                series = [{"labels": lbl, "value": v}
                          for lbl, v in inst.items()]
            out[name] = {"type": inst.kind, "series": series}
            if inst.overflow_dropped:
                out[name]["overflow_dropped"] = inst.overflow_dropped
        return out

    def snapshot_line(self):
        """The whole registry as ONE compact JSON line."""
        return json.dumps(self.snapshot(), separators=(",", ":"),
                          sort_keys=True)

    def prometheus_text(self):
        """Prometheus text exposition format 0.0.4 (grammar checked by
        observability.export.parse_prometheus_text; no external dep)."""
        lines = []
        for name in self.names():
            inst = self._instruments[name]
            if inst.help:
                lines.append("# HELP %s %s" % (
                    name, inst.help.replace("\\", "\\\\")
                    .replace("\n", "\\n")))
            lines.append("# TYPE %s %s" % (name, inst.kind))
            if inst.kind == "histogram":
                for lbl, s in inst.series():
                    acc = 0
                    with s._lock:
                        counts = list(s.counts)
                        total, ssum = s.count, s.sum
                        exm = {i: ring[-1] for i, ring
                               in s.exemplars.items() if ring}
                    for i, (bound, c) in enumerate(zip(s.bounds,
                                                       counts)):
                        acc += c
                        lines.append("%s_bucket%s %d%s" % (
                            name,
                            _fmt_labels(lbl, le=_fmt_float(bound)),
                            acc, _fmt_exemplar(exm.get(i))))
                    lines.append("%s_bucket%s %d%s" % (
                        name, _fmt_labels(lbl, le="+Inf"), total,
                        _fmt_exemplar(exm.get(len(s.bounds)))))
                    lines.append("%s_sum%s %s" % (
                        name, _fmt_labels(lbl), _fmt_float(ssum)))
                    lines.append("%s_count%s %d" % (
                        name, _fmt_labels(lbl), total))
            else:
                for lbl, v in inst.items():
                    lines.append("%s%s %s" % (
                        name, _fmt_labels(lbl), _fmt_float(v)))
        return "\n".join(lines) + "\n"

    def reset(self):
        """Tests only: drop every instrument (callers holding handles
        keep writing to orphans, so only use between isolated tests)."""
        with self._lock:
            self._instruments.clear()


def _fmt_float(v):
    if v != v:                      # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 2 ** 53 else repr(f)


def _fmt_exemplar(ex):
    """OpenMetrics exemplar suffix for a bucket line, or "".

    Grammar (docs/OBSERVABILITY.md; parsed by export.
    parse_prometheus_text):  ``# {trace_id="<id>"} <value> <unix_ts>``
    appended after the bucket's cumulative count.  Absent exemplars
    append nothing, so an exemplar-free exposition is byte-identical
    to the exemplar-free format."""
    if ex is None:
        return ""
    tid, v, ts = ex
    return ' # {trace_id="%s"} %s %s' % (
        _escape_label_value(tid), _fmt_float(v), _fmt_float(ts))


def _escape_label_value(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(labels, **extra):
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, _escape_label_value(v)) for k, v in items)


_registry = MetricsRegistry()


def registry():
    """The process-wide registry every subsystem instruments onto."""
    return _registry


def counter(name, help="", max_series=64):
    return _registry.counter(name, help=help, max_series=max_series)


def gauge(name, help="", max_series=64):
    return _registry.gauge(name, help=help, max_series=max_series)


def histogram(name, help="", buckets=None, max_series=64,
              exemplar_capacity=1):
    return _registry.histogram(name, help=help, buckets=buckets,
                               max_series=max_series,
                               exemplar_capacity=exemplar_capacity)
