"""Fleet collector: cross-process aggregation of the observability
plane.

Counterpart of ``paddle_tpu/observability/collector.py``, with the same
push payload, the same ``collector_push`` and ``fleetz`` messages and
the same loss contract, so a pusher of either package feeds a collector
of the other.  The per-process plane is the port's own: each process
owns a metrics registry, a span ring, and a flight recorder.  A Fluid fleet is many
processes (trainers, pservers, serving/decode replicas), so the fleet
questions ("what is the p99 across replicas?", "which stage of THIS
slow trace ran in which process?") need one place where the
per-process surfaces meet.  That place is the ``CollectorServer``:

  - **pushes**: serving/decode replicas run a ``CollectorPusher`` on a
    timer; trainers push at step boundaries (``maybe_step_push()`` in
    the executor step path — one module-global None check when off).
    A push carries the registry snapshot, the finished-span batch
    since the last ACKED push, flight-recorder dump paths, and the
    process's SLO evaluation, over the ordinary RPC wire as msg type
    ``collector_push`` — which means the chaos plane
    (distributed/faultinject.py) can drop/close/delay pushes by plan,
    and the loss contract below is testable.
  - **pulls**: pservers already answer the ``varz`` RPC;
    ``poll_varz(endpoint)`` ingests a pserver's snapshot without the
    pserver knowing the collector exists.

Loss contract (seeded by faultinject, asserted in
tests/test_fleet_observability.py and, over the port,
tests/test_torch_collector.py): a lost push NEVER wedges the
pushing process (one short-deadline, zero-retry call per tick; the
failure is counted and the batch retained) and never corrupts the
fleet view — the pusher freezes the unacked batch and re-sends it
with the SAME ``seq`` until acked, the collector ingests a seq at
most once, and dump references dedup by path, so span batches land
exactly once and a trace is eventually COMPLETE or its process is
marked ``stale`` (no third state).  The collector itself never blocks
in a handler.

Fleet view (``snapshot()`` / ``snapshot_line()`` / the ``/fleetz``
route on every MetricsHTTPServer):

  - per-process entries with bounded cardinality: past
    ``max_processes`` distinct process names, new ones collapse into
    one ``overflow`` entry (the metrics-registry discipline applied to
    the process label);
  - fleet-level metric series: every per-process series re-tagged with
    ``process``/``role`` labels;
  - the assembled cross-process trace store: client+server spans
    already share trace ids over the ``__trace1__`` envelope — here
    they are joined in ONE store instead of two per-process rings
    (``trace(tid)`` / ``trace_complete(tid)``), which is what lets a
    histogram exemplar's trace id resolve to the full
    submit -> ... -> delivery story including the envelope-joined
    server span from another process;
  - the fleet SLO roll-up: per-process (good, total) pairs sum into
    one fleet attainment/burn-rate row per objective.

``dump(reason)`` writes the whole view as one JSON file and announces
it on stderr with the parseable contract (tools/check_test_hung.py
renders a "Fleet snapshot" section from it):

    COLLECTOR FLEET SNAPSHOT: <path> (reason=R, processes=N, traces=M)

Default OFF: nothing here runs unless a CollectorServer is started or
``PADDLE_TPU_COLLECTOR`` names an endpoint — collector off means zero
new wire bytes (asserted).

Env knobs: ``PADDLE_TPU_COLLECTOR`` (endpoint the pushers target),
``PADDLE_TPU_COLLECTOR_PUSH_INTERVAL`` (seconds between pushes,
default 1.0), ``PADDLE_TPU_COLLECTOR_DEADLINE`` (per-push RPC budget,
default 2.0), ``PADDLE_TPU_COLLECTOR_STALE_AFTER`` (seconds without a
push before a process is stale, default 3x the push interval),
``PADDLE_TPU_COLLECTOR_TRACE_CAPACITY`` (assembled-trace bound,
default 4096).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
import threading
import time
from collections import OrderedDict

from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracing as _tracing

__all__ = [
    "CollectorServer", "CollectorPusher", "maybe_collector",
    "install", "uninstall", "maybe_step_push", "reset_env_pusher",
    "MSG_PUSH",
]

MSG_PUSH = "collector_push"

# pusher-side health instruments: a lost push is visible, never fatal
_M_PUSHES = _metrics.counter(
    "paddle_tpu_collector_pushes_total",
    "collector pushes by outcome (ok / failed)", max_series=16)

_PROCESS_OVERFLOW = "overflow"


def _env_float(name, default):
    v = os.environ.get(name)
    return default if not v else float(v)


def _env_int(name, default):
    v = os.environ.get(name)
    return default if not v else int(v)


def push_interval(default=1.0):
    return _env_float("PADDLE_TPU_COLLECTOR_PUSH_INTERVAL", default)


def collector_endpoint():
    """PADDLE_TPU_COLLECTOR, or None (collector off — the default)."""
    return os.environ.get("PADDLE_TPU_COLLECTOR") or None


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class CollectorServer:
    """The fleet-side half: RPC ingest + trace assembly + fleet view.

    ``endpoint`` binds the ingest RPCServer (``"127.0.0.1:0"`` for an
    ephemeral port; read ``.endpoint`` after construction).
    ``http_port`` additionally mounts a MetricsHTTPServer (0 =
    ephemeral) so ``/fleetz`` is scrapeable from this process."""

    def __init__(self, endpoint="127.0.0.1:0", http_port=None,
                 stale_after=None, max_processes=32,
                 max_traces=None):
        from paddle_tpu_torch.distributed.rpc import RPCServer

        self._rpc = RPCServer(endpoint)
        self.endpoint = self._rpc.endpoint
        self._rpc.register_handler(MSG_PUSH, self._handle_push)
        self._rpc.register_handler(
            "fleetz", lambda _payload=None: self.snapshot())
        self.stale_after = float(stale_after) if stale_after \
            is not None else _env_float(
                "PADDLE_TPU_COLLECTOR_STALE_AFTER",
                3.0 * push_interval())
        self.max_processes = int(max_processes)
        self.max_traces = int(max_traces) if max_traces is not None \
            else _env_int("PADDLE_TPU_COLLECTOR_TRACE_CAPACITY", 4096)
        self._http_port = http_port
        self.http_server = None
        self._lock = threading.Lock()
        # process -> {role, last_push_t, last_seq, metrics, slo,
        #             pushes, span_count}
        self._processes: dict = {}
        # trace_id -> {(process, span_id): span dict} (insertion order
        # = eviction order; bounded at max_traces)
        self._traces: OrderedDict = OrderedDict()
        self.traces_evicted = 0
        # (process, path) -> dump meta — exactly-once by construction
        self._dumps: OrderedDict = OrderedDict()
        self._started = False

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if not self._started:
            self._started = True
            self._rpc.start()
            install(self)
            if self._http_port is not None:
                from paddle_tpu_torch.observability.export import \
                    MetricsHTTPServer

                self.http_server = MetricsHTTPServer(
                    port=self._http_port).start()
        return self

    def stop(self):
        if self._started:
            self._started = False
            if self.http_server is not None:
                self.http_server.stop()
                self.http_server = None
            self._rpc.stop()
            if maybe_collector() is self:
                uninstall()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- ingest -------------------------------------------------------------
    def _process_entry(self, process, role):
        """Bounded get-or-create of a process slot: past
        ``max_processes`` distinct names, everything lands in one
        ``overflow`` entry (the cardinality discipline of the metrics
        registry, applied to the process label)."""
        p = self._processes.get(process)
        if p is None:
            if len(self._processes) >= self.max_processes and \
                    process != _PROCESS_OVERFLOW:
                process = _PROCESS_OVERFLOW
                p = self._processes.get(process)
            if p is None:
                p = self._processes[process] = {
                    "role": role, "last_push_t": 0.0, "last_seq": -1,
                    "metrics": {}, "slo": None, "pushes": 0,
                    "span_count": 0}
        return process, p

    def _handle_push(self, payload):
        """The ``collector_push`` handler.  Ingest is one bounded
        dict/list pass under the collector lock — it never blocks on
        anything external, so a slow or chaos-ridden fleet can never
        wedge the collector (and vice versa)."""
        if not isinstance(payload, dict):
            raise ValueError("collector_push payload must be a dict")
        process = str(payload.get("process") or "unknown")
        role = str(payload.get("role") or "unknown")
        seq = payload.get("seq")
        with self._lock:
            process, p = self._process_entry(process, role)
            p["role"] = role
            p["last_push_t"] = time.time()
            p["pushes"] += 1
            # state-shaped fields refresh on EVERY push (idempotent
            # snapshots), even a deduped retry — only the delta-shaped
            # fields (spans) are seq-gated
            if payload.get("metrics") is not None:
                p["metrics"] = payload["metrics"]
            if payload.get("slo") is not None:
                p["slo"] = payload["slo"]
            for path in payload.get("dumps") or []:
                # exactly-once by (process, path) key — a re-pushed
                # path is the same reference, not a second dump
                self._dumps.setdefault((process, str(path)), {
                    "process": process, "path": str(path)})
            fresh = seq is None or int(seq) > p["last_seq"]
            if fresh and seq is not None:
                p["last_seq"] = int(seq)
            if fresh:
                for span in payload.get("spans") or []:
                    self._ingest_span(process, p, span)
        return {"acked": seq}

    def _ingest_span(self, process, p, span):
        if not isinstance(span, dict) or "trace_id" not in span:
            return
        tid = str(span["trace_id"])
        t = self._traces.get(tid)
        if t is None:
            if len(self._traces) >= self.max_traces:
                self._traces.popitem(last=False)
                self.traces_evicted += 1
            t = self._traces[tid] = {}
        key = (process, str(span.get("span_id")))
        if key not in t:
            t[key] = dict(span, process=process)
            p["span_count"] += 1

    def poll_varz(self, endpoint, role="pserver", process=None,
                  client=None, deadline=None):
        """PULL a pserver's registry snapshot over its existing
        ``varz`` RPC — the pserver needs no collector wiring at
        all.  Returns the ingested process name, or None on failure
        (the endpoint will read as stale, never as a crash here)."""
        from paddle_tpu_torch.distributed.rpc import global_rpc_client

        client = client or global_rpc_client()
        try:
            snap = client.call(
                endpoint, "varz", None, retries=0,
                deadline=deadline if deadline is not None
                else _env_float("PADDLE_TPU_COLLECTOR_DEADLINE", 2.0))
        except Exception:
            return None
        process = process or "%s@%s" % (role, endpoint)
        with self._lock:
            process, p = self._process_entry(process, role)
            p["last_push_t"] = time.time()
            p["pushes"] += 1
            p["metrics"] = snap if isinstance(snap, dict) else {}
        return process

    # -- trace assembly -----------------------------------------------------
    def trace(self, trace_id):
        """The assembled cross-process trace: span dicts (each carrying
        ``process``), parents before children where ids allow, sorted
        by (process, t0)."""
        with self._lock:
            t = self._traces.get(str(trace_id))
            spans = [dict(v) for v in t.values()] if t else []
        spans.sort(key=lambda s: (s.get("process") or "",
                                  s.get("t0_us") or 0.0))
        return spans

    def trace_ids(self):
        with self._lock:
            return list(self._traces)

    def trace_complete(self, trace_id):
        """True iff the assembled trace has exactly >= 1 root and every
        span's parent_id resolves to a span IN the store — the
        "no partial traces" check: a trace missing a dropped push's
        spans fails this until the retried batch lands."""
        spans = self.trace(trace_id)
        if not spans:
            return False
        ids = {s.get("span_id") for s in spans}
        roots = [s for s in spans if s.get("parent_id") is None]
        return bool(roots) and all(
            s.get("parent_id") in ids for s in spans
            if s.get("parent_id") is not None)

    # -- fleet view ---------------------------------------------------------
    def fleet_metrics(self):
        """Every per-process metric series re-tagged with bounded
        ``process``/``role`` labels: {metric: {type, series: [...]}}"""
        with self._lock:
            procs = {name: (p["role"], p["metrics"])
                     for name, p in self._processes.items()}
        out: dict = {}
        for pname, (role, snap) in sorted(procs.items()):
            if not isinstance(snap, dict):
                continue
            for metric, doc in snap.items():
                if not isinstance(doc, dict) or "series" not in doc:
                    continue
                slot = out.setdefault(metric, {
                    "type": doc.get("type"), "series": []})
                for s in doc["series"]:
                    labels = dict(s.get("labels") or {})
                    labels["process"] = pname
                    labels["role"] = role
                    slot["series"].append(dict(s, labels=labels))
        return out

    def fleet_slo(self):
        """Per-objective fleet roll-up: sum of per-process (good,
        total) -> fleet attainment; burn rates weighted by each
        process's total; firing iff any process fires."""
        with self._lock:
            evals = [(name, p["slo"])
                     for name, p in self._processes.items()
                     if isinstance(p.get("slo"), dict)]
        out: dict = {}
        for _pname, slo in evals:
            for obj, e in slo.items():
                if not isinstance(e, dict):
                    continue
                agg = out.setdefault(obj, {
                    "good": 0.0, "total": 0.0, "burn_weight": 0.0,
                    "burn_acc": 0.0, "firing": False,
                    "target": e.get("objective", e.get("target")),
                    "processes": 0})
                good, total = e.get("good"), e.get("total")
                if good is not None and total is not None:
                    agg["good"] += float(good)
                    agg["total"] += float(total)
                burn = e.get("burn_rate_slow", e.get("burn_rate"))
                if burn is not None and total:
                    agg["burn_acc"] += float(burn) * float(total)
                    agg["burn_weight"] += float(total)
                agg["firing"] = agg["firing"] or bool(e.get("firing"))
                agg["processes"] += 1
        fleet = {}
        for obj, agg in out.items():
            fleet[obj] = {
                "attained": (agg["good"] / agg["total"])
                if agg["total"] else None,
                "target": agg["target"],
                "burn_rate": (agg["burn_acc"] / agg["burn_weight"])
                if agg["burn_weight"] else None,
                "firing": agg["firing"],
                "good": agg["good"], "total": agg["total"],
                "processes": agg["processes"],
            }
        return fleet

    def snapshot(self, include_traces=False):
        """The fleet document served by /fleetz.  Per-process entries
        carry the staleness flag (no push within ``stale_after``
        seconds -> ``stale: true`` — the degrade-gracefully contract:
        a partitioned process reads as stale, never as missing data
        silently)."""
        now = time.time()
        with self._lock:
            procs = {}
            for name, p in self._processes.items():
                age = now - p["last_push_t"] if p["last_push_t"] \
                    else None
                procs[name] = {
                    "role": p["role"],
                    "last_push_age_s": round(age, 3)
                    if age is not None else None,
                    "stale": age is None or age > self.stale_after,
                    "pushes": p["pushes"],
                    "last_seq": p["last_seq"],
                    "span_count": p["span_count"],
                }
            n_traces = len(self._traces)
            trace_ids = list(self._traces)[-64:]
            dumps = [dict(d) for d in self._dumps.values()]
        doc = {
            "metric": "fleet_snapshot",
            "collected_at": now,
            "endpoint": self.endpoint,
            "stale_after_s": self.stale_after,
            "processes": procs,
            "n_processes": len(procs),
            "n_traces": n_traces,
            "traces_evicted": self.traces_evicted,
            "trace_ids": trace_ids,
            "dumps": dumps,
            "slo_fleet": self.fleet_slo(),
            "metrics": self.fleet_metrics(),
        }
        if include_traces:
            doc["traces"] = {tid: self.trace(tid)
                             for tid in self.trace_ids()}
        return doc

    def snapshot_line(self):
        """The whole fleet view as ONE compact JSON line."""
        return json.dumps(self.snapshot(), separators=(",", ":"),
                          sort_keys=True)

    # -- dump ---------------------------------------------------------------
    def dump(self, reason="explicit", path=None, announce=True):
        """Write the fleet snapshot (WITH assembled traces) to a JSON
        file; announce on stderr with the parseable contract
        check_test_hung.py renders.  Returns the path or None (a dump
        is diagnostics, never a crash)."""
        doc = self.snapshot(include_traces=True)
        if path is None:
            d = os.environ.get("PADDLE_TPU_FLIGHT_DIR") or \
                os.path.join(tempfile.gettempdir(),
                             "paddle_tpu_flight")
            try:
                os.makedirs(d, exist_ok=True)
            except OSError:
                return None
            path = os.path.join(d, "fleet_%d_%s.json" % (
                os.getpid(), str(reason).replace("/", "_")))
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            return None
        if announce:
            print("COLLECTOR FLEET SNAPSHOT: %s (reason=%s, "
                  "processes=%d, traces=%d)"
                  % (path, reason, doc["n_processes"],
                     doc["n_traces"]), file=sys.stderr)
        return path


# ---------------------------------------------------------------------------
# pusher
# ---------------------------------------------------------------------------

class CollectorPusher:
    """The process-side half: a daemon thread pushing this process's
    registry snapshot, finished-span batches, flight-dump paths, and
    SLO evaluation to the collector.

    Push-loss discipline (module docstring): each tick is ONE RPC with
    retries=0 and a short deadline; on failure the span batch is
    FROZEN (same seq, re-sent next tick) and the failure is counted —
    the pushing process never blocks on the collector, and the
    collector's seq dedup makes delivery exactly-once.

    ``mode="timer"`` pushes every ``interval_s``; ``mode="step"``
    pushes only when ``step_boundary()`` fires (the trainer shape —
    rate-limited to ``interval_s``)."""

    def __init__(self, endpoint, role="serving", process=None,
                 interval_s=None, deadline=None, registry=None,
                 mode="timer"):
        self.endpoint = str(endpoint)
        self.role = str(role)
        self.process = process or "%s@%s-%d" % (
            self.role, socket.gethostname(), os.getpid())
        self.interval_s = float(interval_s) if interval_s is not None \
            else push_interval()
        self.deadline = float(deadline) if deadline is not None \
            else _env_float("PADDLE_TPU_COLLECTOR_DEADLINE", 2.0)
        self._registry = registry or _metrics.registry()
        if mode not in ("timer", "step"):
            raise ValueError("mode must be 'timer' or 'step'")
        self.mode = mode
        self._client = None
        self._cursor = 0            # tracer ring read position
        self._pending = None        # frozen unacked batch
        self._seq = 0
        self._last_push_t = 0.0
        self.pushes_ok = 0
        self.pushes_failed = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is None:
            from paddle_tpu_torch.distributed.rpc import RPCClient

            self._client = RPCClient()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="collector-pusher")
            self._thread.start()
        return self

    def stop(self, final_push=True):
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=2.0)
            self._thread = None
            if final_push:
                try:
                    self.push_now()
                except Exception:
                    pass
            if self._client is not None:
                self._client.close()
                self._client = None
        global _pusher
        if _pusher is self:
            _pusher = None

    def _loop(self):
        while not self._stop.is_set():
            timeout = self.interval_s if self.mode == "timer" else None
            self._wake.wait(timeout)
            self._wake.clear()
            if self._stop.is_set():
                break
            try:
                self.push_now()
            except Exception:   # a pusher bug must never take the
                pass            # serving/training process down

    def step_boundary(self):
        """The trainer hook (executor step path): request a push,
        rate-limited to the interval; returns immediately (the push
        itself runs on the pusher thread, off the step path)."""
        if time.monotonic() - self._last_push_t >= self.interval_s:
            self._wake.set()

    # -- one push -----------------------------------------------------------
    def _batch(self):
        """The frozen unacked batch, or a fresh one.  Spans enter a
        batch exactly once (the ring cursor advances at batch
        formation); the batch keeps its seq until the collector acks
        it, so a reply-lost push that DID land dedups server-side."""
        if self._pending is None:
            spans = []
            t = _tracing.maybe_tracer()
            if t is not None:
                new, self._cursor = t.spans_since(self._cursor)
                spans = [_tracing.span_to_dict(s) for s in new]
            self._seq += 1
            self._pending = {"seq": self._seq, "spans": spans}
        return self._pending

    def push_now(self):
        """One push attempt; returns True iff acked.  Never raises for
        transport failures (counted + retained); raises only for
        programming errors."""
        batch = self._batch()
        slo_evals = None
        try:
            from paddle_tpu_torch.observability import slo as _slo

            if _slo._monitor is not None:
                slo_evals = _slo._monitor.observe()
        except Exception:
            slo_evals = None
        payload = {
            "process": self.process, "role": self.role,
            "seq": batch["seq"], "spans": batch["spans"],
            "metrics": self._registry.snapshot(),
            "slo": slo_evals,
            "dumps": _flight.dump_paths(),
            "ts": time.time(),
        }
        self._last_push_t = time.monotonic()
        try:
            self._client.call(self.endpoint, MSG_PUSH, payload,
                              deadline=self.deadline, retries=0)
        except Exception:
            self.pushes_failed += 1
            _M_PUSHES.inc(outcome="failed")
            _flight.record("collector", "push_failed",
                           endpoint=self.endpoint,
                           seq=batch["seq"],
                           n_spans=len(batch["spans"]))
            return False
        self._pending = None
        self.pushes_ok += 1
        _M_PUSHES.inc(outcome="ok")
        return True


# ---------------------------------------------------------------------------
# process-wide installation
# ---------------------------------------------------------------------------

_collector = None           # the installed CollectorServer (/fleetz)
_pusher = None              # the installed global pusher (trainers)
_env_checked = False


def install(c):
    """Install a CollectorServer process-wide (done by start());
    /fleetz and tools consult it via maybe_collector()."""
    global _collector
    _collector = c
    return c


def uninstall():
    global _collector
    _collector = None


def maybe_collector():
    """The installed CollectorServer, or None (the common case — one
    module-global read)."""
    return _collector


def install_pusher(p):
    """Install a pusher as THE process pusher consulted by
    maybe_step_push() (trainers; serving servers keep their own
    instance instead)."""
    global _pusher
    _pusher = p
    return p


def maybe_step_push():
    """The executor step-boundary hook: nothing unless a pusher is
    installed or PADDLE_TPU_COLLECTOR is set (checked once).  Cost
    when off: one module-global None check + one memo check."""
    global _env_checked, _pusher
    p = _pusher
    if p is not None:
        p.step_boundary()
        return
    if _env_checked:
        return
    _env_checked = True
    ep = collector_endpoint()
    if ep:
        _pusher = CollectorPusher(ep, role="trainer",
                                  mode="step").start()
        _pusher.step_boundary()


def reset_env_pusher():
    """Tests only: forget the env-derived pusher memo so a later env
    change is honored."""
    global _env_checked, _pusher
    _env_checked = False
    if _pusher is not None:
        _pusher.stop(final_push=False)
        _pusher = None
