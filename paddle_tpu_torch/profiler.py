"""Profiler: the Fluid-shaped ``start_profiler``/``stop_profiler``/
``RecordEvent`` surface.

Counterpart of ``paddle_tpu/profiler.py``: a thin shim over
``observability/tracing.py``.  ``RecordEvent`` spans land in a
profiler-owned ``Tracer`` between ``start_profiler`` and
``stop_profiler`` (and ALSO join the process tracer when the ``tracing``
flag is on, so op spans appear inside request traces), and
``export_chrome_tracing`` writes the tracer's chrome-trace JSON — same
signatures, same file shape, merged across workers by
``tools/timeline.py``.

The device half is ``observability.device_trace.DeviceTraceSession`` on
``torch.profiler``: ``start_profiler(tracer_option=...)`` opens one,
recording the card unless ``state`` is ``"CPU"``, and
``device_trace(logdir)`` is a capture into ``logdir``.  Remote profiling
(``start_remote_profiler``/``stop_remote_profiler``) drives the
parameter servers' ``profile`` handler (``ops/ps_ops.py``) through the
RPC client: each pserver opens such a session on its device and writes
the merged chrome trace when profiling stops.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

from paddle_tpu_torch.observability import tracing as _trace

# profiler-owned tracer: enabled between start/stop_profiler,
# independent of the process ``tracing`` flag (the legacy
# profile_ops/profiler() contract must work with tracing off)
_prof_tracer = None
# the device half: a DeviceTraceSession opened by
# start_profiler(tracer_option=...) plus the session-wide annotation
# that binds the ACTIVE span context into the torch.profiler timeline
_device_session = None
_session_annot = None


class RecordEvent:
    """Host event span (reference platform/profiler.h:81).  Exact
    legacy signature; a tracing span site: records into the profiler
    tracer when profiling is on AND into the process tracer when the
    ``tracing`` flag is on (joining the active trace)."""

    __slots__ = ("name", "_spans")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._spans = []
        if _prof_tracer is not None:
            self._spans.append(
                _prof_tracer.span(self.name).__enter__())
        if _trace._tracer is not None:
            self._spans.append(
                _trace._tracer.span(self.name).__enter__())
        return self

    def __exit__(self, *exc):
        for sp in reversed(self._spans):
            sp.__exit__(*(exc or (None, None, None)))
        return False


def start_profiler(state="All", tracer_option=None):
    """Open a profiling session.  ``state`` keeps the legacy CPU/GPU/
    All signature (host spans always record); ``tracer_option``
    (reference: Default / OpDetail / AllOpDetail) is the DEVICE path:
    any non-None value also opens a ``DeviceTraceSession`` (on the card,
    or on the host alone when ``state`` is ``"CPU"``) and binds the
    span context into it — a session-wide annotation carries the ACTIVE
    trace id (when the ``tracing`` flag is on) so device slices
    captured here join the request's trace, and ``stop_profiler`` routes
    through the session's parse/join.  A capture already running in the
    process leaves this session without its device half."""
    global _prof_tracer, _device_session, _session_annot
    _prof_tracer = _trace.Tracer()
    if tracer_option is not None:
        from paddle_tpu_torch.observability import device_trace as _device

        try:
            _device_session = _device.DeviceTraceSession(
                device="cpu" if state == "CPU" else "cuda").start()
        except _device.CaptureRunningError:
            _device_session = None
        if _device_session is not None:
            ctx = _trace.current()
            _session_annot = _device.session_annotation(
                "profiler", ctx[0] if ctx is not None else None)
            _session_annot.__enter__()


def stop_profiler(sorted_key=None, profile_path=None):
    global _prof_tracer, _device_session, _session_annot
    t = _prof_tracer
    _prof_tracer = None
    session, annot = _device_session, _session_annot
    _device_session = _session_annot = None
    if annot is not None:
        annot.__exit__(None, None, None)
    if session is not None:
        session.stop()    # parse + join + registry attribution
    if t is None:
        return
    if profile_path:
        if session is not None:
            # chrome export with the device tracks merged in (same
            # traceEvents shape; tools/timeline.py merges it as-is)
            session.export_merged(profile_path, tracer=t)
        else:
            t.export_chrome_trace(profile_path)
    if sorted_key:
        _print_summary(t, sorted_key)
    return session


def _print_summary(tracer, sorted_key="total"):
    agg = {}
    for s in tracer.spans():
        dur = (s.t1_ns or s.t0_ns) - s.t0_ns
        tot, cnt, mx = agg.get(s.name, (0, 0, 0))
        agg[s.name] = (tot + dur, cnt + 1, max(mx, dur))
    keyfn = {"total": lambda kv: kv[1][0],
             "max": lambda kv: kv[1][2],
             "calls": lambda kv: kv[1][1],
             "ave": lambda kv: kv[1][0] / kv[1][1]}.get(
        sorted_key, lambda kv: kv[1][0])
    print(f"{'Event':40s} {'Calls':>8s} {'Total(ms)':>12s} "
          f"{'Ave(ms)':>10s} {'Max(ms)':>10s}")
    for name, (tot, cnt, mx) in sorted(agg.items(), key=keyfn,
                                       reverse=True):
        print(f"{name:40s} {cnt:8d} {tot / 1e6:12.3f} "
              f"{tot / cnt / 1e6:10.3f} {mx / 1e6:10.3f}")


def export_chrome_tracing(path):
    """Chrome trace like the reference's tools/timeline.py (exports the
    CURRENT profiler session's spans; call before stop_profiler, or
    pass profile_path to stop_profiler)."""
    t = _prof_tracer
    if t is None:
        # legacy tolerance: an export after stop writes an empty trace
        t = _trace.Tracer(capacity=1)
    return t.export_chrome_trace(path)


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None,
             tracer_option=None):
    """reference profiler.py:225 profiler guard (tracer_option opens
    the device half — see start_profiler)."""
    start_profiler(state, tracer_option=tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def device_trace(logdir=None, device="cuda"):
    """A torch.profiler capture of the card's activity (``device``
    "cpu": the host's) into ``logdir`` (default ``paddle_tpu_trace``
    under the temporary directory), as a ``DeviceTraceSession`` writes
    it (replaces CUPTI DeviceTracer)."""
    from paddle_tpu_torch.observability import device_trace as _device

    session = _device.DeviceTraceSession(
        logdir or os.path.join(tempfile.gettempdir(), "paddle_tpu_trace"),
        device=device).start()
    try:
        yield
    finally:
        session.stop()


def reset_profiler():
    if _prof_tracer is not None:
        _prof_tracer.clear()


def start_remote_profiler(endpoints):
    """Switch profiling ON across the cluster's pservers (reference
    send_recv.proto.in:81 VariableMessage.profile — the trainer-driven
    remote profiling trigger)."""
    from paddle_tpu_torch.distributed.rpc import global_rpc_client

    client = global_rpc_client()
    return [client.call(ep, "profile", "start") for ep in endpoints]


def stop_remote_profiler(endpoints, profile_path=None):
    """Switch remote profiling OFF; each pserver writes its chrome trace
    (default ``profile_ps_<endpoint>`` in its temporary directory, the
    reference's ``/tmp/profile_ps_*`` convention) and returns the path.
    An explicit profile_path gets a per-endpoint suffix when there are
    several endpoints — co-hosted pservers must not clobber one trace
    file."""
    from paddle_tpu_torch.distributed.rpc import global_rpc_client

    client = global_rpc_client()
    out = []
    for ep in endpoints:
        path = profile_path
        if path is not None and len(endpoints) > 1:
            path = "%s.%s" % (path, ep.replace(":", "_"))
        out.append(client.call(ep, "profile", ("stop", path)))
    return out
