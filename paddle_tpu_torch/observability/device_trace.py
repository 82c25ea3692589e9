"""Device-time attribution: span the port's kernels and the compiled step
into the SAME trace ids the host spans carry.

Counterpart of ``paddle_tpu/observability/device_trace.py``, on
``torch.profiler`` where the JAX package uses ``jax.profiler``.  Two
halves:

**Annotation emission** — every hand-kernel entry point
(``flash_attention``, ``flash_decode``, ``fc_epilogue``,
``conv2d_epilogue``, ``conv2d_bn_act``, paged-KV ``append``) and every
``CompiledProgram`` step/compile wraps its work in ``annotate(kernel)``:

  - tracing flag OFF: the site is ONE module-global None check — callers
    guard with ``if tracing._tracer is not None`` exactly like span
    sites;
  - ON: a ``torch.profiler.record_function`` range whose name carries
    the kernel and the ACTIVE trace id under the grammar
    ``pt#<kernel>#<trace_id>`` (``pt#<kernel>#-`` when no trace is
    active; an UNSAMPLED trace emits nothing — head sampling reaches the
    device plane too).  The grammar avoids ``:``, as the JAX package's
    does.

A CUDA-graph replay runs no kernel entry: the entries ran once, at the
capture, and a record_function range is host-only, so no trace id is
baked into a graph.  A replayed kernel takes its kernel name from its
function (``_build.KERNEL_SYMBOLS``: each ``csrc/`` source's kernel
functions and the annotation names they run under) and its trace id
from the ``executor.step`` annotation that holds the replay's
``cudaGraphLaunch``.

**DeviceTraceSession** — wraps ``torch.profiler.profile`` (CPU and, by
default, CUDA activity, every thread's: a server's replicas run on
threads of their own), exports the chrome trace into ``logdir``, parses
it and joins device slices back to host spans:

  join (a CUDA session): an ANNOTATION is a host ``user_annotation``
  range whose name parses under the grammar; a DEVICE slice is a
  ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` event.  CUDA launches
  are asynchronous, so a kernel usually runs after the range that
  launched it has closed, and the JAX package's midpoint join would lose
  it: each slice joins, through its ``correlation`` id, the host event
  that launched it (``cudaLaunchKernel``/``cuLaunchKernel``,
  ``cudaGraphLaunch`` for a replay, ``cudaMemcpyAsync``,
  ``cudaMemsetAsync``), then the INNERMOST annotation on the launching
  thread whose window holds the launch.  The slice's kernel is that
  annotation's, unless its function is one of the port's kernels, which
  names it (a conv kernel keeps ``conv2d_bn_act`` where that annotation
  launched it).
  A CPU session (``device="cpu"``, the tests) has no device lanes: the
  top-level ``cpu_op`` events stand in for device slices, each joined to
  the innermost annotation on its thread that holds its start, as the
  XLA CPU runtime's ops do in the JAX package.

On ``stop()`` the session feeds the metrics registry:

  paddle_tpu_device_kernel_seconds_total{kernel=...}   joined device
      seconds per kernel
  paddle_tpu_device_step_seconds_total{component=...}  step-time
      breakdown over the ``executor.step`` windows: compute, transfer
      (memcpy/memset/copy slices), host_gap (the rest of the window)
  paddle_tpu_device_trace_slices_total{kind=...}       annotation /
      device / joined event counts (the join's own health)

A step's window runs from its annotation's start to the later of its
end and the end of the last device slice joined to it: on the card the
range closes before the step's kernels finish.  compute + transfer +
host_gap = total, window by window, in whole nanoseconds.

``merged_chrome_trace(tracer)`` merges the device tracks into the host
tracer's chrome-trace events (the tools/timeline.py shape): device
processes land on pids from 100000 on with ``process_name`` metadata,
and every joined slice carries ``args.trace_id``.

Env knobs: ``PADDLE_TPU_DEVICE_TRACE_DIR`` (session log directory;
default a fresh tempdir per session).
"""

from __future__ import annotations

import bisect
import glob
import itertools
import json
import os
import tempfile

import torch

from paddle_tpu_torch._build import KERNEL_SYMBOLS
from paddle_tpu_torch.core.types import NoCUDADeviceError
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import tracing as _tracing

__all__ = ["annotate", "annotation_name", "parse_annotation",
           "session_annotation", "DeviceTraceSession",
           "CaptureRunningError"]

ANNOTATION_PREFIX = "pt#"

_M_KERNEL_SECONDS = _metrics.counter(
    "paddle_tpu_device_kernel_seconds_total",
    "joined device seconds per annotated kernel/step", max_series=64)
_M_STEP_SECONDS = _metrics.counter(
    "paddle_tpu_device_step_seconds_total",
    "executor.step wall decomposition: compute / transfer / host_gap",
    max_series=8)
_M_SLICES = _metrics.counter(
    "paddle_tpu_device_trace_slices_total",
    "DeviceTraceSession parse/join counts, by kind", max_series=8)

# the JAX package's markers, and CUDA's "Memcpy HtoD/DtoH/DtoD" (which
# "copy" does not catch) and "Memset"
_TRANSFER_MARKERS = ("copy", "transfer", "infeed", "outfeed",
                     "h2d", "d2h", "reshard", "memset", "memcpy")
# the chrome trace's categories: host ranges, device slices, launches
_ANNOTATION_CAT = "user_annotation"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

_SESSIONS = itertools.count()


class CaptureRunningError(RuntimeError):
    """A torch.profiler capture is already running in this process.
    torch starts a second one without complaint and the first then
    records nothing, so a session refuses to start beside another."""


def annotation_name(kernel, trace_id=None):
    """``pt#<kernel>#<trace_id>`` (grammar: no colons)."""
    return "%s%s#%s" % (ANNOTATION_PREFIX, kernel, trace_id or "-")


def parse_annotation(name):
    """(kernel, trace_id | None) for a grammar-conformant name, else
    None."""
    if not name or not name.startswith(ANNOTATION_PREFIX):
        return None
    parts = name[len(ANNOTATION_PREFIX):].rsplit("#", 1)
    if len(parts) != 2 or not parts[0]:
        return None
    kernel, tid = parts
    return kernel, (None if tid in ("", "-") else tid)


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def annotate(kernel):
    """The kernel-entry annotation site.  Callers keep the
    one-conditional shape::

        if tracing._tracer is not None:
            with device_trace.annotate("flash_attention"):
                return _flash(...)
        return _flash(...)

    (calling it with tracing off also just returns a null context —
    the guard is about the disabled COST, not correctness)."""
    t = _tracing._tracer
    if t is None:
        return _NULL
    ctx = _tracing.current()
    tid = ctx[0] if ctx is not None else None
    if tid is not None and not t._head_sampled(tid):
        return _NULL            # head sampling reaches the device plane
    return torch.profiler.record_function(annotation_name(kernel, tid))


def session_annotation(kernel, trace_id=None):
    """An UNGATED annotation (profiler.py's device session binds the
    active span ctx with this even when the ``tracing`` flag is off —
    the explicit start_profiler(tracer_option=...) request is its own
    opt-in)."""
    return torch.profiler.record_function(annotation_name(kernel,
                                                          trace_id))


def _union_us(intervals):
    """Total microseconds covered by a list of (start, end)."""
    if not intervals:
        return 0.0
    total = 0.0
    start = end = None
    for s, e in sorted(intervals):
        if start is None:
            start, end = s, e
        elif s > end:
            total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    total += end - start
    return total


def _ns(us):
    """A chrome trace's microseconds (three decimals) as whole ns."""
    return int(round(float(us) * 1000.0))


def _symbol_kernels():
    """[(kernel function, annotation names)] of every csrc source."""
    return [(sym, names) for syms, names in KERNEL_SYMBOLS.values()
            for sym in syms]


_SYMBOLS = _symbol_kernels()


def kernel_of_function(name):
    """The annotation names a device slice's function runs under, when
    it is one of the port's kernels (demangled or not), else None."""
    for sym, names in _SYMBOLS:
        if sym in name:
            return names
    return None


class DeviceTraceSession:
    """One torch.profiler capture window + the parse/join/attribute
    pass (module docstring).  Use as a context manager or
    start()/stop().  ``device`` "cuda" (the default) records the card's
    activity, and ``start()`` raises ``NoCUDADeviceError`` without one;
    "cpu" records the host alone (its ops stand in for device slices).
    A session never started parses the newest trace in ``logdir``, as
    the JAX package's does.  After stop():

      .annotations    [{kernel, trace_id, ts, dur, file, pid, tid}]
      .device_slices  [{name, ts, dur, pid, tid, file, transfer, ...}]
      .joined         device slices + {kernel, trace_id} from the join
      .kernel_seconds()   {kernel: joined device seconds}
      .step_breakdown()   {total, compute, transfer, host_gap} seconds
      .merged_chrome_trace(tracer) / .export_merged(path, tracer)
    """

    def __init__(self, logdir=None, registry=None, device="cuda"):
        device = torch.device(device)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"DeviceTraceSession: device {device} is "
                             "neither the card nor the CPU")
        self.device = device
        self.logdir = logdir or \
            os.environ.get("PADDLE_TPU_DEVICE_TRACE_DIR") or \
            tempfile.mkdtemp(prefix="paddle_tpu_devtrace_")
        self.trace_path = None
        self._registry = registry   # None -> module instruments
        self.annotations = []
        self.device_slices = []
        self.joined = []
        self._meta = []             # raw metadata events for the merge
        self._prof = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            if self.device.type == "cuda" and \
                    not torch.cuda.is_available():
                raise NoCUDADeviceError(
                    "DeviceTraceSession: no CUDA device is available; "
                    "pass device='cpu' to record the host alone")
            if torch.autograd.profiler._is_profiler_enabled:
                raise CaptureRunningError(
                    "a torch.profiler capture is already running in this "
                    "process")
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.logdir, exist_ok=True)
            # the servers' worker threads launch the kernels: record the
            # annotations of every thread, not the caller's alone
            prof = profile(
                activities=activities,
                experimental_config=torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True))
            prof.start()
            self._prof = prof
        return self

    def stop(self):
        """Stop the capture, export and parse the trace, run the join,
        feed the registry.  Returns self (inspect the attributes)."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.stop()
            self.trace_path = os.path.join(
                self.logdir, "device_trace.%d.%d.json"
                % (os.getpid(), next(_SESSIONS)))
            prof.export_chrome_trace(self.trace_path)
        elif self.trace_path is None:
            # never started: the newest trace a capture left in logdir
            found = sorted(glob.glob(os.path.join(
                self.logdir, "device_trace.*.json")), key=os.path.getmtime)
            self.trace_path = found[-1] if found else None
        self._parse()
        self._join()
        self._feed_registry()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- parse --------------------------------------------------------------
    def _parse(self):
        self.annotations, self.device_slices, self._meta = [], [], []
        path = self.trace_path
        if path is None:
            return
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        launches = {}
        ops = []
        for ev in events:
            ph, cat = ev.get("ph"), ev.get("cat")
            if ph == "M" and ev.get("name") == "process_name":
                self._meta.append((path, ev))
                continue
            if ph != "X":
                continue
            args = ev.get("args") or {}
            if cat == _ANNOTATION_CAT:
                parsed = parse_annotation(str(ev.get("name", "")))
                if parsed is not None:
                    self.annotations.append({
                        "kernel": parsed[0], "trace_id": parsed[1],
                        "ts": float(ev.get("ts", 0.0)),
                        "dur": float(ev.get("dur", 0.0)), "file": path,
                        "pid": ev.get("pid"), "tid": ev.get("tid")})
            elif cat in _LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ev
            elif cat in _DEVICE_CATS and self.device.type == "cuda":
                self.device_slices.append(self._slice(ev, path, cat))
            elif cat == "cpu_op" and self.device.type == "cpu":
                ops.append(ev)
        for s in self.device_slices:
            launch = launches.get(s.pop("correlation"))
            if launch is not None:
                s["launch"] = (launch.get("pid"), launch.get("tid"),
                               float(launch.get("ts", 0.0)))
        for ev in _top_level(ops):
            s = self._slice(ev, path, "cpu_op")
            del s["correlation"]
            s["launch"] = (s["pid"], s["tid"], s["ts"])
            self.device_slices.append(s)

    @staticmethod
    def _slice(ev, path, cat):
        name = str(ev.get("name", ""))
        lname = name.lower()
        return {"name": name, "ts": float(ev.get("ts", 0.0)),
                "dur": float(ev.get("dur", 0.0)), "pid": ev.get("pid"),
                "tid": ev.get("tid"), "file": path, "cat": cat,
                "correlation": (ev.get("args") or {}).get("correlation"),
                "launch": None,
                "transfer": cat in ("gpu_memcpy", "gpu_memset")
                or any(m in lname for m in _TRANSFER_MARKERS)}

    # -- join ---------------------------------------------------------------
    def _join(self):
        """Each slice to the innermost annotation holding its launch on
        the launching thread (and its innermost ``executor.step``)."""
        self.joined = []
        by_thread: dict = {}
        for i, a in enumerate(self.annotations):
            by_thread.setdefault((a["file"], a["pid"], a["tid"]),
                                 []).append((a["ts"], i))
        for anns in by_thread.values():
            anns.sort()
        for s in self.device_slices:
            if s.get("launch") is None:
                continue
            pid, tid, lts = s["launch"]
            anns = by_thread.get((s["file"], pid, tid))
            if not anns:
                continue
            best = step = None
            for _, i in anns[:bisect.bisect_right(anns, (lts, len(
                    self.annotations)))]:
                a = self.annotations[i]
                if lts > a["ts"] + a["dur"]:
                    continue
                if best is None or a["dur"] < \
                        self.annotations[best]["dur"]:
                    best = i        # innermost enclosing window
                if a["kernel"] == "executor.step" and (
                        step is None or a["dur"]
                        < self.annotations[step]["dur"]):
                    step = i
            if best is None:
                continue
            a = self.annotations[best]
            kernel = a["kernel"]
            names = kernel_of_function(s["name"]) \
                if s["cat"] == "kernel" else None
            if names and kernel not in names:
                kernel = names[0]   # a replayed (or nested) port kernel
            j = dict(s)
            j["kernel"] = kernel
            j["trace_id"] = a["trace_id"]
            j["step"] = step
            self.joined.append(j)

    # -- attribution --------------------------------------------------------
    def kernel_seconds(self):
        """{kernel: joined device seconds} — the per-kernel
        device-time attribution (µs resolution from the trace)."""
        out: dict = {}
        for j in self.joined:
            out[j["kernel"]] = out.get(j["kernel"], 0.0) \
                + j["dur"] / 1e6
        return out

    def step_breakdown_ns(self):
        """``step_breakdown`` in whole nanoseconds, where compute +
        transfer + host_gap == total exactly."""
        steps: dict = {i: [] for i, a in enumerate(self.annotations)
                       if a["kernel"] == "executor.step"}
        for j in self.joined:
            if j["step"] in steps:
                steps[j["step"]].append(j)
        total = compute = transfer = 0
        for i, js in steps.items():
            a = self.annotations[i]
            t0 = _ns(a["ts"])
            t1 = max([_ns(a["ts"]) + _ns(a["dur"])]
                     + [_ns(j["ts"]) + _ns(j["dur"]) for j in js])
            busy, moved = [], []
            for j in js:
                iv = (max(t0, _ns(j["ts"])),
                      max(t0, _ns(j["ts"]) + _ns(j["dur"])))
                (moved if j["transfer"] else busy).append(iv)
            c = int(_union_us(busy))
            total += t1 - t0
            compute += c
            # a copy that overlaps a kernel counts once, as compute
            transfer += int(_union_us(busy + moved)) - c
        return {"total": total, "compute": compute, "transfer": transfer,
                "host_gap": total - compute - transfer}

    def step_breakdown(self):
        """Step-time decomposition over the ``executor.step`` windows
        (module docstring): compute (joined kernels), transfer (copies
        and memsets not under a kernel), host_gap (the rest of the
        window — python, dispatch, queueing).  All in seconds."""
        return {k: v / 1e9 for k, v in self.step_breakdown_ns().items()}

    def _feed_registry(self):
        if self._registry is None:
            m_kernel, m_step, m_slices = (_M_KERNEL_SECONDS,
                                          _M_STEP_SECONDS, _M_SLICES)
        else:
            m_kernel = self._registry.counter(
                _M_KERNEL_SECONDS.name, _M_KERNEL_SECONDS.help)
            m_step = self._registry.counter(
                _M_STEP_SECONDS.name, _M_STEP_SECONDS.help)
            m_slices = self._registry.counter(
                _M_SLICES.name, _M_SLICES.help)
        for kernel, secs in self.kernel_seconds().items():
            m_kernel.inc(secs, kernel=kernel)
        bd = self.step_breakdown()
        for component in ("compute", "transfer", "host_gap"):
            if bd[component] > 0.0:
                m_step.inc(bd[component], component=component)
        m_slices.inc(len(self.annotations), kind="annotation")
        m_slices.inc(len(self.device_slices), kind="device")
        m_slices.inc(len(self.joined), kind="joined")

    # -- merge --------------------------------------------------------------
    _PID_OFFSET = 100000   # device lanes land past any real host pid

    def merged_chrome_trace(self, tracer=None):
        """One chrome-trace dict: the host tracer's span events (when
        given) + this session's annotation and device slices, device
        processes re-based onto offset pids with process_name
        metadata, joined slices carrying ``args.trace_id``/``kernel``.
        NOTE the two clock domains: host spans use perf_counter, the
        profiler its own epoch — lanes are per-process tracks, not a
        cross-domain alignment (same as tools/timeline.py's
        per-worker re-basing)."""
        events = list(tracer.chrome_events()) if tracer is not None \
            else []
        pid_map: dict = {}

        def mapped(path, pid):
            key = (path, pid)
            if key not in pid_map:
                pid_map[key] = self._PID_OFFSET + len(pid_map)
            return pid_map[key]

        join_key = {(j["file"], j["pid"], j["tid"], j["ts"]): j
                    for j in self.joined}
        for a in self.annotations:
            events.append({
                "name": annotation_name(a["kernel"], a["trace_id"]),
                "ph": "X", "ts": a["ts"], "dur": a["dur"],
                "pid": mapped(a["file"], "host_annotations"),
                "tid": 0,
                "args": {"kernel": a["kernel"],
                         "trace_id": a["trace_id"]}})
        for s in self.device_slices:
            args = {}
            j = join_key.get((s["file"], s["pid"], s["tid"], s["ts"]))
            if j is not None:
                args = {"trace_id": j["trace_id"],
                        "kernel": j["kernel"]}
            events.append({
                "name": s["name"], "ph": "X", "ts": s["ts"],
                "dur": s["dur"], "pid": mapped(s["file"], s["pid"]),
                "tid": s["tid"], "args": args})
        for (path, pid), new_pid in sorted(pid_map.items(),
                                           key=lambda kv: kv[1]):
            label = "device_annotations" if pid == "host_annotations" \
                else None
            if label is None:
                label = "device:%s" % pid
                for mpath, mev in self._meta:
                    if mpath == path and mev.get("pid") == pid:
                        label = "device:%s" % mev.get(
                            "args", {}).get("name", pid)
                        break
            events.append({"name": "process_name", "ph": "M",
                           "pid": new_pid, "tid": 0,
                           "args": {"name": label}})
        return {"traceEvents": events}

    def export_merged(self, path, tracer=None):
        with open(path, "w") as f:
            json.dump(self.merged_chrome_trace(tracer=tracer), f)
        return path


def _top_level(ops):
    """The ``cpu_op`` events no other ``cpu_op`` of their thread holds:
    the host ops a CPU session takes for device slices."""
    out = []
    by_thread: dict = {}
    for ev in ops:
        by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                -float(e.get("dur", 0.0))))
        end = None
        for ev in evs:
            ts = float(ev.get("ts", 0.0))
            if end is not None and ts < end:
                continue        # inside the op before it
            out.append(ev)
            end = ts + float(ev.get("dur", 0.0))
    return out
