"""Crash flight recorder: a bounded ring of recent structured events,
dumped to a file when something dies.

The distributed/serving stack records its state TRANSITIONS here
(always on — one counter bump and a list-slot store per event, no
locks on the record path): RPC retries/terminal failures, circuit
breaker opens, barrier arrivals/releases/timeouts, batch formations,
decode joins/retires/preemptions, KV page alloc/free, supervisor
restarts, elastic checkpoints, and every chaos action faultinject
applies.  When a ``BarrierTimeoutError`` fires, a replica dies, or a
caller asks (``dump()``), the ring is written as a JSON file — the
causal narrative of the last N events — so a chaos-soak or
elastic-trainer failure replays as a story instead of log archaeology.

Dump announcement contract (parsed by tools/check_test_hung.py):

    FLIGHT RECORDER DUMP: <path> (reason=<reason>, events=<N>)

printed to stderr at dump time.  Dump files land in
``PADDLE_TPU_FLIGHT_DIR`` (default: <tmpdir>/paddle_tpu_flight), named
``flight_<pid>_<seq>_<reason>.json``.

Env knobs: ``PADDLE_TPU_FLIGHT_DIR`` (dump directory),
``PADDLE_TPU_FLIGHT_CAPACITY`` (ring size, default 4096),
``PADDLE_TPU_FLIGHT_DISABLE=1`` (drop dumps — soaks that expect
thousands of kills).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import time

__all__ = ["FlightRecorder", "recorder", "record", "dump",
           "dump_paths"]


def _env_int(name, default):
    v = os.environ.get(name)
    return default if not v else int(v)


class FlightRecorder:
    """Bounded lock-free event ring + crash-dump writer.

    The record path takes no lock: slot index allocation is one
    ``itertools.count`` step (atomic under the GIL) and the write is a
    single list-slot store — safe to call from every worker thread at
    event rates far above anything this stack produces."""

    def __init__(self, capacity=None):
        self.capacity = int(capacity) if capacity is not None else \
            _env_int("PADDLE_TPU_FLIGHT_CAPACITY", 4096)
        self._ring = [None] * self.capacity
        self._idx = itertools.count()
        self._count = 0
        self._dump_seq = itertools.count(1)
        self._dump_paths = []

    # -- record (hot, lock-free) -------------------------------------------
    def record(self, category, event, **fields):
        """One structured event: (wall time, monotonic time, category,
        event, fields).  category groups a subsystem ('rpc', 'barrier',
        'serving', 'decode', 'paged_kv', 'chaos', 'supervisor',
        'elastic', 'executor'); event names the transition."""
        i = next(self._idx)
        self._ring[i % self.capacity] = (
            time.time(), time.monotonic(), category, event,
            fields or None)
        if i + 1 > self._count:
            self._count = i + 1

    # -- read ---------------------------------------------------------------
    def events(self):
        """Recent events oldest-first as dicts (bounded by capacity)."""
        n = self._count
        raw = []
        if n > self.capacity:
            raw.extend(self._ring[n % self.capacity:])
        raw.extend(self._ring[:n % self.capacity])
        out = []
        for rec in raw:
            if rec is None:
                continue
            wall, mono, category, event, fields = rec
            d = {"wall_time": wall, "monotonic": mono,
                 "category": category, "event": event}
            if fields:
                d.update(fields)
            out.append(d)
        return out

    def clear(self):
        self._ring = [None] * self.capacity
        self._idx = itertools.count()
        self._count = 0

    # -- dump ---------------------------------------------------------------
    def dump_dir(self):
        d = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
        if not d:
            d = os.path.join(tempfile.gettempdir(),
                             "paddle_tpu_flight")
        return d

    def dump(self, reason="explicit", path=None, announce=True):
        """Write the ring to a JSON file; returns the path (None when
        PADDLE_TPU_FLIGHT_DISABLE is set or the write failed — a dump
        is diagnostics, never a crash of its own)."""
        if os.environ.get("PADDLE_TPU_FLIGHT_DISABLE"):
            return None
        events = self.events()
        if path is None:
            d = self.dump_dir()
            try:
                os.makedirs(d, exist_ok=True)
            except OSError:
                return None
            path = os.path.join(
                d, "flight_%d_%d_%s.json" % (
                    os.getpid(), next(self._dump_seq),
                    str(reason).replace("/", "_")))
        doc = {"reason": str(reason), "pid": os.getpid(),
               "dumped_at": time.time(),
               "n_events": len(events), "events": events}
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            return None
        self._dump_paths.append(path)
        if announce:
            print("FLIGHT RECORDER DUMP: %s (reason=%s, events=%d)"
                  % (path, reason, len(events)), file=sys.stderr)
        return path

    def dump_paths(self):
        """Paths written by THIS process, oldest first."""
        return list(self._dump_paths)


_recorder = FlightRecorder()


def recorder():
    """The process-wide flight recorder."""
    return _recorder


def record(category, event, **fields):
    """Record onto the process-wide ring (the one-liner every
    instrumented site calls)."""
    _recorder.record(category, event, **fields)


def dump(reason="explicit", path=None, announce=True):
    return _recorder.dump(reason=reason, path=path, announce=announce)


def dump_paths():
    return _recorder.dump_paths()


def load_dump(path):
    """Parse a dump file back into its dict (the check_test_hung /
    test-side reader)."""
    with open(path) as f:
        return json.load(f)
