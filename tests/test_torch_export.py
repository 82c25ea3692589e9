"""The port's ``/metrics`` exporter against the JAX package's.

- The JAX contracts rerun over ``paddle_tpu_torch.observability``:
  ``test_metrics_http_server_endpoints``,
  ``test_prometheus_grammar_check_rejects_malformed``
  (tests/test_observability.py), ``test_parse_prometheus_exemplar_
  accept_and_reject`` (tests/test_fleet_observability.py) and
  ``test_sloz_endpoint_and_healthz_degrades``
  (tests/test_perf_observability.py); ``/fleetz`` answers
  ``{"enabled": false}`` with no collector installed and the installed
  collector's snapshot with one, as in the JAX package.
- The two ``parse_prometheus_text`` accept and reject the same inputs,
  and give the same samples and exemplars; each parses the other
  package's exposition of the same instruments.
- ``metrics_port`` on the servers: a CPU ``InferenceServer`` over a
  1-layer LM with ``metrics_port=0`` and a ``DecodeServer`` under
  ``PADDLE_TPU_METRICS_PORT=0`` (in a process of its own, whose paged-KV
  gauges no earlier cache has filled), each scraped while it serves: the
  counters equal ``stats()``, the page gauges each cache's stats.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_lm
from paddle_tpu.observability import export as jax_export
from paddle_tpu.observability import metrics as jax_metrics
import torch_port_helpers  # noqa: F401  (caps torch's threads)

from paddle_tpu_torch import inference, serving
from paddle_tpu_torch.observability import metrics, slo, tracing
from paddle_tpu_torch.observability.export import (MetricsHTTPServer,
                                                   metrics_port_from_env,
                                                   parse_prometheus_text)

LM = dict(vocab_size=64, max_len=8, d_model=16, n_head=2, d_inner=32,
          n_layer=1, dropout_rate=0.0, is_test=True)


def _get(url):
    return urllib.request.urlopen(url, timeout=5).read().decode()


# ---------------------------------------------------------------------------
# the JAX contracts over the port
# ---------------------------------------------------------------------------

def test_metrics_http_server_endpoints():
    r = metrics.MetricsRegistry()
    r.counter("paddle_tpu_t_http_total").inc(5)
    with MetricsHTTPServer(port=0, registry=r) as srv:
        base = srv.url
        samples = parse_prometheus_text(_get(base + "/metrics"))
        assert ("paddle_tpu_t_http_total", {}, 5.0) in samples
        varz = json.loads(_get(base + "/varz"))
        assert varz["paddle_tpu_t_http_total"]["series"][0][
            "value"] == 5
        assert json.loads(_get(base + "/healthz")) == {"status": "ok"}
        flightz = json.loads(_get(base + "/flightz"))
        assert "events" in flightz and "dumps" in flightz
        assert json.loads(_get(base + "/fleetz")) == {"enabled": False}
        from paddle_tpu_torch.observability import collector

        with collector.CollectorServer("127.0.0.1:0") as coll:
            fleet = json.loads(_get(base + "/fleetz"))
            assert fleet["metric"] == "fleet_snapshot"
            assert fleet["endpoint"] == coll.endpoint
        assert json.loads(_get(base + "/fleetz")) == {"enabled": False}
        tracez = json.loads(_get(base + "/tracez"))
        assert tracez == {"enabled": False, "spans": []}
        with pytest.raises(Exception):
            urllib.request.urlopen(base + "/nope", timeout=5)
    assert srv.port is not None and srv._httpd is None


def test_prometheus_grammar_check_rejects_malformed():
    with pytest.raises(ValueError):
        parse_prometheus_text("bad name{x=1} 2\n")
    with pytest.raises(ValueError):
        parse_prometheus_text('m{k="v} 1\n')
    with pytest.raises(ValueError):
        parse_prometheus_text("m{} not_a_number\n")
    # histogram without +Inf bucket is structurally invalid
    with pytest.raises(ValueError):
        parse_prometheus_text(
            "# TYPE h histogram\n"
            'h_bucket{le="1"} 1\nh_sum 1\nh_count 1\n')


def test_parse_prometheus_exemplar_accept_and_reject():
    base = ("# TYPE m histogram\n"
            'm_bucket{le="1"} 2%s\n'
            'm_bucket{le="+Inf"} 2\n'
            "m_sum 1.0\nm_count 2\n")
    # accepted: with and without timestamp
    for suffix in (' # {trace_id="abc"} 0.5 1700000000.5',
                   ' # {trace_id="abc"} 0.5'):
        samples, ex = parse_prometheus_text(base % suffix,
                                            with_exemplars=True)
        assert ex and ex[0]["value"] == 0.5
    # counters may carry exemplars too
    parse_prometheus_text(
        "# TYPE c counter\nc 3 # {trace_id=\"t\"} 1\n")
    # rejected: malformed label pair / missing value / unterminated /
    # exemplar on a gauge sample
    for bad in (' # {trace_id=} 0.5',
                ' # {trace_id="abc"}',
                ' # {trace_id="abc" 0.5',
                ' # 0.5'):
        with pytest.raises(ValueError):
            parse_prometheus_text(base % bad)
    with pytest.raises(ValueError, match="non-bucket"):
        parse_prometheus_text(
            '# TYPE g gauge\ng 1 # {trace_id="t"} 1\n')


def _counter_slo(reg_name="paddle_tpu_t_slo_reqs_total", **kw):
    return slo.SLO("t_availability", 0.9, 60.0, source={
        "kind": "counter_ratio", "metric": reg_name,
        "good": [{"outcome": "ok"}],
        "total": [{"outcome": "ok"}, {"outcome": "shed"}]}, **kw)


def test_sloz_endpoint_and_healthz_degrades():
    """/sloz parses; /healthz flips to degraded while an alert fires
    and back to the EXACT legacy ok shape when it clears."""
    r = metrics.MetricsRegistry()
    c = r.counter("paddle_tpu_t_slo_reqs_total")
    mon = slo.SLOMonitor(slos=[_counter_slo(fast_fraction=0.25,
                                            burn_alert=2.0)],
                         registry=r)
    prev = slo._monitor
    slo.install(mon)
    try:
        with MetricsHTTPServer(port=0, registry=r) as srv:
            doc = json.loads(_get(srv.url + "/sloz"))
            assert doc["firing"] == []
            (spec,) = doc["slos"]
            assert spec["name"] == "t_availability"
            assert spec["objective"] == 0.9
            assert json.loads(_get(srv.url + "/healthz")) == \
                {"status": "ok"}
            # burn the budget hard and re-probe
            c.inc(5, outcome="ok")
            mon.observe()
            time.sleep(0.02)
            c.inc(100, outcome="shed")
            mon.observe()
            health = json.loads(_get(srv.url + "/healthz"))
            assert health["status"] == "degraded"
            assert health["alerts"] == ["t_availability"]
    finally:
        slo.install(prev)


def test_metrics_port_from_env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_METRICS_PORT", raising=False)
    assert metrics_port_from_env() is None
    assert metrics_port_from_env(7) == 7
    for value, want in (("", None), ("0", 0), ("9123", 9123)):
        monkeypatch.setenv("PADDLE_TPU_METRICS_PORT", value)
        assert metrics_port_from_env() == want == \
            jax_export.metrics_port_from_env()


# ---------------------------------------------------------------------------
# the parser against the JAX package's
# ---------------------------------------------------------------------------

_HIST = ('# TYPE h histogram\nh_bucket{le="1"} 1%s\n'
         'h_bucket{le="+Inf"} 2\nh_sum 3.5\nh_count 2\n')
PARSER_INPUTS = [
    "m 1\n", "m{} 1\n", 'm{a="b",c="d"} 2.5\n', 'm{a="b",} 3\n',
    "m 1 1700000000\n", "m +Inf\n", "m -Inf\n", "m NaN\n", "m .5e3\n",
    "m 1e\n", "m inf\n", "bad name 1\n", "9m 1\n", 'm{k="v} 1\n',
    'm{k=v} 1\n', 'm{k="a\\"b\\nc\\\\d"} 1\n', "m{} not_a_number\n",
    "# HELP m some help\n# TYPE m counter\nm 1\n",
    "# TYPE m counter\n# TYPE m counter\nm 1\n",
    "# TYPE m countr\nm 1\n", "# TYPE m gauge\nother 1\n",
    "# free comment\nm 1\n", "# HELP\n",
    _HIST % "", _HIST % ' # {trace_id="t"} 0.7',
    _HIST % ' # {trace_id="t"} 0.7 1700000000.25',
    _HIST % ' # {trace_id="t",span="s"} 0.7', _HIST % " # {} 0.7",
    _HIST % ' # {trace_id="t"}', _HIST % ' #{trace_id="t"} 1',
    _HIST % ' # {trace_id="t"} x',
    '# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\nh_count 1\n',
    '# TYPE h histogram\nh_bucket{x="1"} 1\n',
    '# TYPE c counter\nc 3 # {trace_id="t"} 1\n',
    '# TYPE g gauge\ng 1 # {trace_id="t"} 1\n',
    "m 1 # not an exemplar\n", "\n\n   \nm 1\n",
]


@pytest.mark.parametrize("text", PARSER_INPUTS)
def test_parser_accepts_and_rejects_as_jax_does(text):
    def parse(fn):
        try:
            return fn(text, with_exemplars=True)
        except ValueError:
            return "rejected"

    port = parse(parse_prometheus_text)
    jax = parse(jax_export.parse_prometheus_text)
    assert repr(port) == repr(jax)       # NaN samples compare by repr


def _fill(reg, tracer_mod):
    """The same instruments and observations in one package's
    registry, one histogram observation under a sampled trace."""
    reg.counter("paddle_tpu_t_reqs_total", "requests").inc(
        3, code='we"ird\nvalue')
    reg.gauge("paddle_tpu_t_depth").set(7, replica="0")
    h = reg.histogram("paddle_tpu_t_lat_seconds", "latency")
    for v in (0.001, 0.02, 0.3, 4.0):
        h.observe(v, outcome="ok")
    t = tracer_mod.start_tracing(sample=1.0)
    try:
        with t.span("r") as root:
            h.observe(0.05, outcome="ok")
    finally:
        tracer_mod.stop_tracing()
    return root.trace_id


def test_each_parser_reads_the_other_packages_exposition():
    from paddle_tpu.observability import tracing as jax_tracing

    port_reg, jax_reg = metrics.MetricsRegistry(), \
        jax_metrics.MetricsRegistry()
    _fill(port_reg, tracing)
    _fill(jax_reg, jax_tracing)
    texts = (port_reg.prometheus_text(), jax_reg.prometheus_text())
    parsed = []
    for text in texts:
        for parse in (parse_prometheus_text,
                      jax_export.parse_prometheus_text):
            samples, ex = parse(text, with_exemplars=True)
            parsed.append((samples, [
                (e["name"], e["labels"], e["value"]) for e in ex]))
    # the trace ids differ, the rest is equal
    assert all(p == parsed[0] for p in parsed[1:])
    assert len(parsed[0][1]) == 1


# ---------------------------------------------------------------------------
# metrics_port on the servers
# ---------------------------------------------------------------------------

def _save_lm(tmp_path):
    model = jax_lm(**LM)
    exe = fluid.Executor(fluid.CPUPlace())
    np.random.seed(0)
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "lm")
    fluid.io.save_inference_model(d, ["src_ids"], [model["logits"]], exe)
    return d


def _predictor(model_dir):
    cfg = inference.Config(model_dir)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def _scrape(url):
    return parse_prometheus_text(_get(url + "/metrics"),
                                 with_exemplars=True)


def _by_label(samples, name, key):
    return {labels.get(key): value for n, labels, value in samples
            if n == name}


def test_inference_server_serves_metrics_and_counts_match_stats(
        tmp_path):
    """metrics_port=0 mounts the exporter at start() and takes it down
    at stop(); the admission counters and the request histogram's count
    move by what stats() counts, and every admitted request's sampled
    trace id is an exemplar that /tracez knows."""
    d = _save_lm(tmp_path)
    rng = np.random.RandomState(3)
    tracer = tracing.start_tracing(sample=1.0)
    tracer.clear()
    try:
        srv = serving.InferenceServer(
            lambda i: _predictor(d),
            serving.ServingConfig(n_replicas=2, max_batch=4,
                                  metrics_port=0)).start()
        url = srv.metrics_server.url
        before, _ = _scrape(url)
        try:
            reqs = [srv.submit({"src_ids": rng.randint(
                0, LM["vocab_size"], (int(n), LM["max_len"], 1))},
                deadline_s=60.0) for n in rng.randint(1, 4, 12)]
            for r in reqs:
                r.result(timeout=60)
            after, exemplars = _scrape(url)
            stats = srv.stats()
            tracez = json.loads(_get(url + "/tracez"))
            assert json.loads(_get(url + "/healthz")) == {"status": "ok"}
        finally:
            srv.stop()
        assert srv.metrics_server is None
        with pytest.raises(OSError):
            urllib.request.urlopen(url + "/metrics", timeout=2)
    finally:
        tracing.stop_tracing()
    adm = "paddle_tpu_admission_requests_total"
    b, a = _by_label(before, adm, "outcome"), _by_label(after, adm,
                                                        "outcome")
    for outcome, n in stats["admission"].items():
        assert a.get(outcome, 0.0) - b.get(outcome, 0.0) == n, outcome
    assert stats["admission"]["admitted"] == stats["answered"] == 12
    cnt = "paddle_tpu_serving_request_seconds_count"
    assert _by_label(after, cnt, "outcome")["ok"] - _by_label(
        before, cnt, "outcome").get("ok", 0.0) == 12
    span_ids = {s["trace_id"] for s in tracez["spans"]}
    mine = [e for e in exemplars
            if e["name"] == "paddle_tpu_serving_request_seconds_bucket"]
    assert mine and all(e["exemplar_labels"]["trace_id"] in span_ids
                        for e in mine)


DECODE_CHILD = r"""
import json, sys, time, urllib.request
import numpy as np
from paddle_tpu_torch import serving
from paddle_tpu_torch.observability.export import parse_prometheus_text
srv = serving.DecodeServer(config=serving.DecodeConfig(
    device="cpu", max_batch=4, page_size=8, num_pages=40,
    max_new_tokens=6)).start()
port = srv.config.metrics_port
url = srv.metrics_server.url
reqs = [srv.submit(np.arange(2, 2 + n)) for n in (5, 9, 14)]
for r in reqs:
    r.result(timeout=120)
deadline = time.monotonic() + 30
while any(rep.cache.stats()["in_use_pages"] for rep in srv.replicas):
    assert time.monotonic() < deadline, "pages still held"
    time.sleep(0.01)
text = urllib.request.urlopen(url + "/metrics", timeout=5).read().decode()
out = {"port": port, "stats": srv.stats(), "samples": [
    [n, l, v] for n, l, v in parse_prometheus_text(text)],
    "labels": [rep.cache._label for rep in srv.replicas],
    "accounting": srv.page_accounting()}
srv.stop()
out["after_stop"] = srv.metrics_server is None
print(json.dumps(out))
"""


def test_decode_server_metrics_port_from_env_and_page_gauges():
    env = dict(os.environ, PADDLE_TPU_METRICS_PORT="0",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", DECODE_CHILD], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["port"] == 0 and out["after_stop"]
    assert out["accounting"] == [True, ""]
    samples = [tuple(s) for s in out["samples"]]
    events = _by_label(samples, "paddle_tpu_decode_events_total", "event")
    for k, v in out["stats"]["decode"].items():
        assert events.get(k, 0.0) == v, k
    assert out["stats"]["answered"] == 3
    for rep, label in zip(out["stats"]["replicas"].values(),
                          out["labels"]):
        cache = rep["cache"]
        for gauge, key in (("free", "free_pages"),
                           ("in_use", "in_use_pages"),
                           ("shared", "shared_pages")):
            got = _by_label(samples, "paddle_tpu_paged_kv_pages_" + gauge,
                            "cache")
            assert got[label] == cache[key], (gauge, got, cache)
