"""SLO engine: declarative objectives evaluated from metrics-registry
snapshots over rolling windows, with Google-SRE-style multi-window
burn-rate alerting.

Counterpart of ``paddle_tpu/observability/slo.py``, over the port's own
metrics registry and flight recorder (the JAX package's series are
never read), with the same objectives, metric names and events.

An ``SLO(name, objective, window_s, source=...)`` names a good/total
ratio readable from the process registry:

  - ``counter_ratio`` sources sum counter series: serving availability
    is ``answered_ok / (admitted + rejected_overloaded)`` over the
    admission instrument — a shed request is an unavailability event
    from the caller's side, which is exactly what makes a 2x-overload
    run burn error budget even while every ADMITTED request meets its
    deadline;
  - ``histogram_under`` sources read a latency histogram's bucket
    prefix: good = observations <= threshold (conservative to the ~2x
    log-bucket resolution), total = count — the p99-vs-deadline and
    decode inter-token objectives.

``SLOMonitor`` samples the cumulative (good, total) pairs, keeps a
bounded ring of (t, sample) points, and on every ``observe()``
computes, per SLO, the error rate over a FAST window (default
window/12 — the 5m-of-1h shape) and the SLOW window, each divided by
the error budget (1 - objective) = the burn rates.  The alert fires
when BOTH burn rates clear the threshold (fast = react in minutes,
slow = don't page on a blip) and clears when either falls back under —
the multi-window burn-rate policy from the SRE workbook.  Every
transition records a flight-recorder event (category ``slo``) so a
post-mortem dump shows WHY the pager fired, and the state is exported
as gauges:

  paddle_tpu_slo_attainment{slo=...}        good/total over the slow
                                            window (1.0 when idle)
  paddle_tpu_slo_burn_rate{slo=..., window=fast|slow}
  paddle_tpu_slo_alert_firing{slo=...}      0/1

The fleet's ``RolloutController`` and ``SLOAutoscaler``
(``serving/fleet.py``) read a monitor.  ``sloz()`` and ``verdict()``
return their documents; the HTTP surfaces that serve them (``/sloz``,
the ``/healthz`` degrade) belong to the metrics exporter, which is not
ported yet (ROADMAP Queue 1 item 4.3).

Env knobs: ``PADDLE_TPU_SLO_WINDOW`` — the default slow-window seconds
(300; tests and the load generator pass short explicit windows).
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from collections import deque

from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _metrics

__all__ = ["SLO", "SLOMonitor", "monitor", "install",
           "default_slos", "serving_availability", "serving_latency",
           "decode_inter_token", "fleet_availability", "peek_firing"]

_G_ATTAIN = _metrics.gauge(
    "paddle_tpu_slo_attainment",
    "good/total over the slow window, by SLO", max_series=64)
_G_BURN = _metrics.gauge(
    "paddle_tpu_slo_burn_rate",
    "error rate over the window / error budget, by SLO and window",
    max_series=128)
_G_FIRING = _metrics.gauge(
    "paddle_tpu_slo_alert_firing",
    "1 while the multi-window burn-rate alert is firing, by SLO",
    max_series=64)


def default_window():
    v = os.environ.get("PADDLE_TPU_SLO_WINDOW")
    return float(v) if v else 300.0


class SLO:
    """One declarative objective.  ``source`` is a JSON-able dict:

      {"kind": "counter_ratio", "metric": <name>,
       "good": [{label: value}, ...], "total": [{...}, ...]}
      {"kind": "histogram_under", "metric": <name>,
       "threshold_s": <float>}

    ``objective`` in (0, 1) is the target good/total ratio over
    ``window_s`` (default PADDLE_TPU_SLO_WINDOW); the alert policy is
    burn_fast >= burn_alert AND burn_slow >= burn_alert, with
    fast = window_s * fast_fraction."""

    def __init__(self, name, objective, window_s=None, *, source,
                 fast_fraction=1.0 / 12.0, burn_alert=2.0):
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(
                "objective must be in (0, 1), got %r" % (objective,))
        if source.get("kind") not in ("counter_ratio",
                                      "histogram_under"):
            raise ValueError("unknown SLO source kind: %r"
                             % (source.get("kind"),))
        self.name = str(name)
        self.objective = float(objective)
        self.window_s = float(window_s) if window_s is not None \
            else default_window()
        self.fast_fraction = float(fast_fraction)
        self.burn_alert = float(burn_alert)
        self.source = dict(source)

    @property
    def fast_window_s(self):
        return max(1e-9, self.window_s * self.fast_fraction)

    def to_dict(self):
        return {"name": self.name, "objective": self.objective,
                "window_s": self.window_s,
                "fast_window_s": self.fast_window_s,
                "burn_alert": self.burn_alert, "source": self.source}

    # -- sampling -----------------------------------------------------------
    def sample(self, registry):
        """Cumulative (good, total) from the live registry (raw
        instruments, not the JSON snapshot — histogram bucket counts
        are needed)."""
        src = self.source
        inst = registry.get(src["metric"])
        if inst is None:
            return 0.0, 0.0
        if src["kind"] == "counter_ratio":
            def _sum(selectors):
                acc = 0.0
                for labels, value in inst.items():
                    for sel in selectors:
                        if all(labels.get(k) == str(v)
                               for k, v in sel.items()):
                            acc += value
                            break
                return acc

            return _sum(src["good"]), _sum(src["total"])
        # histogram_under: good = observations <= threshold via the
        # bucket prefix (conservative to the log-bucket resolution)
        threshold = float(src["threshold_s"])
        good = total = 0.0
        for _labels, series in inst.series():
            i = bisect.bisect_left(series.bounds, threshold)
            if i < len(series.bounds) and \
                    series.bounds[i] == threshold:
                i += 1          # bound == threshold counts as under
            with series._lock:
                counts = list(series.counts)
                total += series.count
            good += sum(counts[:i])
        return good, total


# -- canned objectives -------------------------------------------------------

def serving_availability(objective=0.99, window_s=None, **kw):
    """answered-not-shed over offered: answered_ok / (admitted +
    rejected_overloaded).  Deliberately counts admission sheds against
    the budget — overload IS unavailability to the caller (module
    docstring)."""
    return SLO("serving_availability", objective, window_s, source={
        "kind": "counter_ratio",
        "metric": "paddle_tpu_admission_requests_total",
        "good": [{"outcome": "answered_ok"}],
        "total": [{"outcome": "admitted"},
                  {"outcome": "rejected_overloaded"}]}, **kw)


def serving_latency(deadline_s=1.0, objective=0.99, window_s=None,
                    **kw):
    """p99-vs-deadline as an SLO: >= objective of admitted requests
    answered within ``deadline_s`` (the admission latency histogram)."""
    return SLO("serving_p99_deadline", objective, window_s, source={
        "kind": "histogram_under",
        "metric": "paddle_tpu_serving_request_seconds",
        "threshold_s": float(deadline_s)}, **kw)


def fleet_availability(objective=0.99, window_s=None, **kw):
    """The multi-tenant fleet objective:
    like ``serving_availability`` but QUOTA sheds also count against
    the budget — a tenant shed for being over its own quota is policy
    working as intended, yet it is still unavailability from that
    caller's side, and a fleet drowning in quota sheds is
    under-provisioned.  The SLOAutoscaler watching this objective
    therefore scales on quota pressure too."""
    return SLO("fleet_availability", objective, window_s, source={
        "kind": "counter_ratio",
        "metric": "paddle_tpu_admission_requests_total",
        "good": [{"outcome": "answered_ok"}],
        "total": [{"outcome": "admitted"},
                  {"outcome": "rejected_overloaded"},
                  {"outcome": "rejected_quota"}]}, **kw)


def decode_inter_token(threshold_s=0.1, objective=0.99, window_s=None,
                       **kw):
    """Decode inter-token p99: >= objective of per-token gaps under
    ``threshold_s``."""
    return SLO("decode_inter_token_p99", objective, window_s, source={
        "kind": "histogram_under",
        "metric": "paddle_tpu_decode_inter_token_seconds",
        "threshold_s": float(threshold_s)}, **kw)


def default_slos(window_s=None):
    return [serving_availability(window_s=window_s),
            serving_latency(window_s=window_s),
            decode_inter_token(window_s=window_s)]


class SLOMonitor:
    """Rolling-window evaluator + multi-window burn-rate alerter.

    ``observe()`` is the one entry point: sample, evaluate, update
    gauges, record alert transitions; returns the evaluation dict.
    ``start(interval_s)`` runs observe on a daemon thread."""

    def __init__(self, slos=None, registry=None, window_s=None):
        self.slos = list(slos) if slos is not None \
            else default_slos(window_s=window_s)
        self._registry = registry or _metrics.registry()
        self._max_window = max([s.window_s for s in self.slos],
                               default=default_window())
        self._samples: deque = deque()   # (t, {name: (good, total)})
        self._lock = threading.Lock()
        self.alerts = {s.name: False for s in self.slos}
        self._last_eval: dict = {}
        self._thread = None
        self._stop = threading.Event()

    # -- evaluation ---------------------------------------------------------
    def _window_delta(self, name, window_s, now):
        """(d_good, d_total) between now's sample and the newest
        sample at least ``window_s`` old (or the oldest available —
        a short history truncates the window rather than inventing
        data)."""
        cur = self._samples[-1][1].get(name, (0.0, 0.0))
        base = None
        for t, sample in self._samples:
            if t <= now - window_s:
                base = sample.get(name, (0.0, 0.0))
            else:
                break
        if base is None:
            base = self._samples[0][1].get(name, (0.0, 0.0))
        return cur[0] - base[0], cur[1] - base[1]

    def observe(self, now=None):
        """Take one sample and evaluate every SLO.  Returns
        {name: {objective, window_s, attained, good, total,
        burn_rate_fast, burn_rate_slow, firing}}."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            sample = {s.name: s.sample(self._registry)
                      for s in self.slos}
            self._samples.append((now, sample))
            horizon = now - 2.0 * self._max_window
            while len(self._samples) > 2 and \
                    self._samples[1][0] < horizon:
                self._samples.popleft()
            evals = {}
            for s in self.slos:
                evals[s.name] = self._evaluate_one(s, now)
            self._last_eval = evals
        return evals

    def _evaluate_one(self, s, now):
        budget = 1.0 - s.objective

        def burn(window_s):
            d_good, d_total = self._window_delta(s.name, window_s,
                                                 now)
            if d_total <= 0:
                return None, None
            err = max(0.0, 1.0 - d_good / d_total)
            return err / budget, d_good / d_total

        burn_fast, _ = burn(s.fast_window_s)
        burn_slow, attained = burn(s.window_s)
        good, total = self._samples[-1][1][s.name]
        was = self.alerts[s.name]
        firing = (burn_fast is not None and burn_slow is not None
                  and burn_fast >= s.burn_alert
                  and burn_slow >= s.burn_alert)
        if firing != was:
            self.alerts[s.name] = firing
            # the pager's post-mortem: WHY it fired rides the flight
            # ring into any dump that follows
            _flight.record(
                "slo", "alert_firing" if firing else "alert_cleared",
                slo=s.name, objective=s.objective,
                burn_fast=round(burn_fast, 3) if burn_fast is not None
                else None,
                burn_slow=round(burn_slow, 3) if burn_slow is not None
                else None,
                attained=round(attained, 5) if attained is not None
                else None)
        _G_ATTAIN.set(1.0 if attained is None else attained,
                      slo=s.name)
        _G_BURN.set(0.0 if burn_fast is None else burn_fast,
                    slo=s.name, window="fast")
        _G_BURN.set(0.0 if burn_slow is None else burn_slow,
                    slo=s.name, window="slow")
        _G_FIRING.set(1.0 if firing else 0.0, slo=s.name)
        return {"objective": s.objective, "window_s": s.window_s,
                "attained": attained, "good": good, "total": total,
                "burn_rate_fast": burn_fast,
                "burn_rate_slow": burn_slow, "firing": firing}

    # -- surfaces -----------------------------------------------------------
    def firing(self):
        with self._lock:
            return sorted(n for n, f in self.alerts.items() if f)

    def sloz(self, observe=True):
        """The /sloz document (JSON-able; the endpoint itself is the
    exporter's, not ported yet)."""
        evals = self.observe() if observe else dict(self._last_eval)
        return {"slos": [dict(s.to_dict(), **evals.get(s.name, {}))
                         for s in self.slos],
                "firing": self.firing()}

    def verdict(self):
        """The compact per-objective embed for one-JSON-line outputs:
        {name: {attained, target, burn_rate, firing}}."""
        evals = self.observe()
        return {name: {"attained": e["attained"],
                       "target": e["objective"],
                       "burn_rate": e["burn_rate_slow"],
                       "firing": e["firing"]}
                for name, e in evals.items()}

    # -- background evaluation ---------------------------------------------
    def start(self, interval_s=1.0):
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(interval_s):
                    try:
                        self.observe()
                    except Exception:   # an evaluator bug must never
                        pass            # take the serving process down

            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None


# -- process-wide default monitor -------------------------------------------

_monitor = None
_monitor_lock = threading.Lock()


def monitor():
    """The process monitor (lazy default: the three canned objectives
    over PADDLE_TPU_SLO_WINDOW)."""
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = SLOMonitor()
        return _monitor


def install(m):
    """Replace (or with None, reset) the process monitor."""
    global _monitor
    with _monitor_lock:
        _monitor = m
    return m


def peek_firing():
    """Firing alert names WITHOUT forcing a monitor into existence
    (no monitor -> nothing firing)."""
    m = _monitor
    return [] if m is None else m.firing()
