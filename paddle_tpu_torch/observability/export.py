"""HTTP exposition of the observability surface + the in-tree
prometheus text-format grammar checker.

Counterpart of ``paddle_tpu/observability/export.py``, over the port's
own registry, flight recorder, tracer and SLO engine.

``MetricsHTTPServer`` serves, on a daemon thread:

    /metrics    prometheus text exposition of the process registry
    /varz       the registry snapshot as one JSON document
    /flightz    recent flight-recorder events (JSON)
    /tracez     finished-span summary when tracing is on (JSON)
    /fleetz     the installed fleet collector's snapshot
                (observability/collector.py), or {"enabled": false}
                when this process runs no collector
    /sloz       the SLO engine's evaluation (objectives, attainment,
                fast/slow burn rates, firing alerts — observability/
                slo.py; evaluates on request)
    /healthz    {"status": "ok"} — DEGRADED to {"status": "degraded",
                "alerts": [...]} while any SLO burn-rate alert fires
                (the load balancer's view of the SLO engine)

It is mounted on ``InferenceServer`` and ``DecodeServer``
(``ServingConfig(metrics_port=...)`` / ``DecodeConfig(metrics_port=
...)`` / env ``PADDLE_TPU_METRICS_PORT``).  Port 0 binds an ephemeral
port (read ``server.port``).

``parse_prometheus_text`` is the grammar check — a strict-enough parser
of exposition format 0.0.4 (names, label pairs, escapes, values,
HELP/TYPE comments, histogram ``le``/+Inf shape) with no external
dependency.
"""

from __future__ import annotations

import json
import re
import threading

from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracing as _tracing

__all__ = ["MetricsHTTPServer", "parse_prometheus_text",
           "metrics_port_from_env"]


def _slo_firing():
    """Firing SLO alerts — re-evaluated live when a monitor exists,
    [] (never a crash, never a forced monitor) otherwise."""
    try:
        from paddle_tpu_torch.observability import slo as _slo

        m = _slo._monitor
        if m is None:
            return []
        m.observe()
        return m.firing()
    except Exception:
        return []


def metrics_port_from_env(default=None):
    """PADDLE_TPU_METRICS_PORT -> int port (0 = ephemeral), or
    ``default`` when unset/empty."""
    import os

    v = os.environ.get("PADDLE_TPU_METRICS_PORT")
    if v is None or v == "":
        return default
    return int(v)


class MetricsHTTPServer:
    """Tiny threading HTTP server for the /metrics + /varz surface."""

    def __init__(self, port=0, host="127.0.0.1", registry=None):
        self._host = host
        self._want_port = int(port)
        self._registry = registry or _metrics.registry()
        self._httpd = None
        self._thread = None
        self.port = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._httpd is not None:
            return self
        import http.server

        reg = self._registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence per-request stderr
                pass

            def _send(self, body, ctype):
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(reg.prometheus_text(),
                               "text/plain; version=0.0.4")
                elif path == "/varz":
                    self._send(json.dumps(reg.snapshot(),
                                          sort_keys=True),
                               "application/json")
                elif path == "/flightz":
                    self._send(json.dumps(
                        {"events":
                         _flight.recorder().events()[-256:],
                         "dumps": _flight.dump_paths()}),
                        "application/json")
                elif path == "/tracez":
                    t = _tracing.maybe_tracer()
                    spans = [] if t is None else [
                        {"name": s.name, "trace_id": s.trace_id,
                         "span_id": s.span_id,
                         "parent_id": s.parent_id,
                         "dur_us": ((s.t1_ns or s.t0_ns) - s.t0_ns)
                         / 1e3}
                        for s in t.spans()[-256:]]
                    self._send(json.dumps(
                        {"enabled": t is not None, "spans": spans}),
                        "application/json")
                elif path == "/fleetz":
                    # fleet view: the installed collector's snapshot, or
                    # an explicit disabled marker — the route exists on
                    # every server so a scraper can probe without
                    # knowing which process collects
                    from paddle_tpu_torch.observability import \
                        collector as _collector

                    c = _collector.maybe_collector()
                    self._send(
                        json.dumps(c.snapshot(), sort_keys=True)
                        if c is not None else '{"enabled": false}',
                        "application/json")
                elif path == "/sloz":
                    from paddle_tpu_torch.observability import slo as _slo

                    self._send(json.dumps(_slo.monitor().sloz(),
                                          sort_keys=True),
                               "application/json")
                elif path == "/healthz":
                    firing = _slo_firing()
                    if firing:
                        self._send(json.dumps(
                            {"status": "degraded", "alerts": firing}),
                            "application/json")
                    else:
                        self._send('{"status": "ok"}',
                                   "application/json")
                else:
                    self.send_error(404)

        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=2.0)
                self._thread = None

    @property
    def url(self):
        return None if self.port is None else \
            "http://%s:%d" % (self._host, self.port)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# -- prometheus text grammar (exposition format 0.0.4) ----------------------

_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_HELP_RE = re.compile(r"# HELP (%s) (.*)\Z" % _PROM_NAME)
_TYPE_RE = re.compile(
    r"# TYPE (%s) (counter|gauge|histogram|summary|untyped)\Z"
    % _PROM_NAME)
_VALUE_PAT = (r"[+-]?(?:\d+(?:\.\d*)?(?:[eE][+-]?\d+)?|\.\d+"
              r"(?:[eE][+-]?\d+)?|Inf|NaN)")
_SAMPLE_RE = re.compile(
    r"(?P<name>%s)(?:\{(?P<labels>[^}]*)\})?\s+"
    r"(?P<value>%s)(?:\s+(?P<ts>-?\d+))?\Z"
    % (_PROM_NAME, _VALUE_PAT))
# OpenMetrics exemplar suffix: appended to a histogram
# bucket (or counter) sample as `# {trace_id="..."} value [unix_ts]`.
# The strict form: exactly one space-separated comment marker, a
# braced label set, a value, and an optional float timestamp at EOL.
_EXEMPLAR_RE = re.compile(
    r"\s#\s\{(?P<elabels>(?:[^\"{}]|\"(?:[^\"\\]|\\.)*\")*)\}"
    r"\s(?P<evalue>%s)"
    r"(?:\s(?P<ets>[+-]?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?))?\Z"
    % _VALUE_PAT)
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*'
    r'"(?P<v>(?:[^"\\]|\\.)*)"\s*(?P<sep>,|\Z)')


def _parse_labels(text):
    labels = {}
    pos = 0
    while pos < len(text):
        m = _LABEL_PAIR_RE.match(text, pos)
        if m is None:
            raise ValueError(f"bad label pair at {text[pos:]!r}")
        v = m.group("v").replace('\\"', '"').replace("\\n", "\n") \
            .replace("\\\\", "\\")
        labels[m.group("k")] = v
        pos = m.end()
    return labels


def parse_prometheus_text(text, with_exemplars=False):
    """Validate + parse exposition text.  Returns
    ``[(name, labels_dict, value)]`` samples; raises ValueError on any
    grammar violation.  Extra structural checks: a TYPE may be
    announced at most once per name; histogram samples only use the
    ``_bucket``/``_sum``/``_count`` suffixes of an announced histogram
    and every bucket run ends with ``le="+Inf"``.

    OpenMetrics exemplars: a sample line may end with
    ``# {trace_id="..."} <value> [<unix_ts>]`` — accepted ONLY on
    histogram ``_bucket`` samples and counter samples (the OpenMetrics
    rule); the label set must parse, the value must be a number, and a
    ``#`` that does not open a well-formed exemplar is a grammar
    violation.  With ``with_exemplars=True`` returns
    ``(samples, exemplars)`` where exemplars is
    ``[{name, labels, exemplar_labels, value, ts}]``."""
    samples = []
    exemplars = []
    types = {}
    hist_bucket_le: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if _HELP_RE.match(line):
                continue
            m = _TYPE_RE.match(line)
            if m:
                name, kind = m.group(1), m.group(2)
                if name in types:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for {name}")
                types[name] = kind
                continue
            if line.startswith("# HELP") or line.startswith("# TYPE"):
                raise ValueError(
                    f"line {lineno}: malformed comment: {line!r}")
            continue     # free-form comments are legal
        m_ex = _EXEMPLAR_RE.search(line)
        if m_ex is not None:
            base_line = line[:m_ex.start()]
        else:
            base_line = line
            if " # " in line:
                raise ValueError(
                    f"line {lineno}: malformed exemplar (a '#' on a "
                    f"sample line must open "
                    f"'# {{label=\"v\"}} value [ts]'): {line!r}")
        m = _SAMPLE_RE.match(base_line)
        if m is None:
            raise ValueError(f"line {lineno}: bad sample: {line!r}")
        name = m.group("name")
        labels = _parse_labels(m.group("labels") or "")
        raw = m.group("value")
        value = float(raw.replace("Inf", "inf").replace("NaN", "nan"))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    types.get(name[: -len(suffix)]) in ("histogram",
                                                        "summary"):
                base = name[: -len(suffix)]
                break
        if types and base not in types and name not in types:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no TYPE")
        if name.endswith("_bucket") and \
                types.get(base) == "histogram":
            if "le" not in labels:
                raise ValueError(
                    f"line {lineno}: histogram bucket without le")
            key = (base, tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le")))
            hist_bucket_le.setdefault(key, []).append(labels["le"])
        if m_ex is not None:
            is_bucket = name.endswith("_bucket") and \
                types.get(base) == "histogram"
            is_counter = types.get(name) == "counter"
            if not (is_bucket or is_counter):
                raise ValueError(
                    f"line {lineno}: exemplar on a non-bucket/"
                    f"non-counter sample {name!r} (OpenMetrics allows "
                    "exemplars on histogram buckets and counters "
                    "only)")
            elabels = _parse_labels(m_ex.group("elabels") or "")
            eraw = m_ex.group("evalue")
            evalue = float(eraw.replace("Inf", "inf")
                           .replace("NaN", "nan"))
            ets = m_ex.group("ets")
            exemplars.append({
                "name": name, "labels": labels,
                "exemplar_labels": elabels, "value": evalue,
                "ts": float(ets) if ets is not None else None})
        samples.append((name, labels, value))
    for (base, _), les in hist_bucket_le.items():
        if "+Inf" not in les:
            raise ValueError(
                f"histogram {base} bucket run missing le=\"+Inf\"")
    if with_exemplars:
        return samples, exemplars
    return samples
