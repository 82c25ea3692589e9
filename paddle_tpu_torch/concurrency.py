"""Shared bounded-queue / supervised-worker primitives.

Extracted from the Communicator so the serving tier
reuses the exact same discipline instead of forking it:

  - ``BoundedQueue``: a bounded FIFO whose ``put`` blocks for
    backpressure (a producer outrunning a wedged consumer blocks
    instead of growing without bound) and whose ``drain`` is the
    non-blocking batch pop both the grad sender and the batcher use.
    Raises the stdlib ``queue.Full`` / ``queue.Empty`` so existing
    callers keep their handlers.
  - ``Supervisor``: named worker loops run under a guard that reports
    any escaped exception into an error queue (``errors()``) instead of
    dying silently, and a supervisor thread restarts dead workers with
    exponential backoff (``restarts()`` counts) — a transient outage
    costs restarts, not the job.  Workers registered with
    ``restart=False`` stay down once dead (the serving pool uses this
    for replicas that must fail over rather than resurrect).

Reference contrast: the C++ Communicator SendThread/RecvThread
(operators/distributed/communicator.h:160) log-and-die; everything
built on this module must survive unattended runs.
"""

from __future__ import annotations

import queue
import threading
import time

from paddle_tpu_torch.observability import flight_recorder as _flight
from paddle_tpu_torch.observability import metrics as _obs_metrics

__all__ = ["BoundedQueue", "Supervisor"]

_M_RESTARTS = _obs_metrics.counter(
    "paddle_tpu_supervisor_restarts_total",
    "supervised worker restarts, by worker name", max_series=128)
_M_WORKER_ERRORS = _obs_metrics.counter(
    "paddle_tpu_supervisor_worker_errors_total",
    "exceptions escaped from supervised worker loops", max_series=128)


class BoundedQueue:
    """Bounded FIFO: blocking ``put`` backpressure + batch ``drain``."""

    def __init__(self, maxsize=0):
        self._q = queue.Queue(maxsize=maxsize)

    def put(self, item, block=True, timeout=None):
        """Enqueue; blocks when full (backpressure) unless block=False
        (raises ``queue.Full``)."""
        self._q.put(item, block=block, timeout=timeout)

    def put_nowait(self, item):
        self._q.put_nowait(item)

    def get(self, block=True, timeout=None):
        return self._q.get(block=block, timeout=timeout)

    def get_nowait(self):
        return self._q.get_nowait()

    def drain(self, max_items=None):
        """Non-blocking pop of up to ``max_items`` (None = everything
        currently queued); returns the (possibly empty) list."""
        items = []
        while max_items is None or len(items) < max_items:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                break
        return items

    def qsize(self):
        return self._q.qsize()

    def empty(self):
        return self._q.empty()

    @property
    def maxsize(self):
        return self._q.maxsize


class Supervisor:
    """Guarded worker loops + restart-with-backoff supervision.

    Worker functions take no arguments and are expected to loop on
    ``supervisor.running``; returning normally counts as a clean exit
    (still restarted while running, unless registered restart=False —
    a worker that should stay down must flip its own liveness state
    before returning, e.g. a dead serving replica)."""

    def __init__(self, restart_backoff=0.1, max_backoff=2.0, poll=0.05):
        self._loops: dict = {}       # name -> (fn, restart)
        self._threads: dict = {}     # name -> Thread
        self._errors = queue.Queue()  # (name, exception)
        self._error_log = []         # drained copy, errors() returns it
        self._restarts: dict = {}
        self._running = False
        self._thread = None
        self._backoff = float(restart_backoff)
        self._max_backoff = float(max_backoff)
        self._poll = float(poll)

    @property
    def running(self):
        return self._running

    def add_worker(self, name, fn, restart=True):
        """Register (and, if already running, immediately spawn) a
        named worker loop."""
        self._loops[name] = (fn, bool(restart))
        self._restarts.setdefault(name, 0)
        if self._running:
            self._spawn(name, fn)
        return self

    def remove_worker(self, name):
        """Deregister a worker loop: the supervisor stops restarting
        it (the retirement half of elastic pools — a live thread
        finishes its current pass and is joined by stop()).  Returns
        True when the name was registered."""
        return self._loops.pop(name, None) is not None

    def start(self):
        if self._running:
            return self
        self._running = True
        for name, (fn, _) in self._loops.items():
            self._spawn(name, fn)
        self._thread = threading.Thread(target=self._supervise,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout=5.0):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
        for th in self._threads.values():
            th.join(timeout=join_timeout)

    def alive(self, name):
        th = self._threads.get(name)
        return th is not None and th.is_alive()

    def report_error(self, name, exc):
        """Record an error on a worker's behalf (e.g. shutdown flush)."""
        self._errors.put((name, exc))

    def errors(self):
        """Every exception a worker reported (name, exc), oldest first;
        empty when all workers have been healthy."""
        while True:
            try:
                self._error_log.append(self._errors.get_nowait())
            except queue.Empty:
                break
        return list(self._error_log)

    def restarts(self):
        return dict(self._restarts)

    # -- internals ----------------------------------------------------------
    def _spawn(self, name, fn):
        def guarded():
            try:
                fn()
            except Exception as e:   # report, never die silently
                self._errors.put((name, e))
                _M_WORKER_ERRORS.inc(worker=name)
                _flight.record("supervisor", "worker_error",
                               worker=name, error=repr(e)[:200])

        th = threading.Thread(target=guarded, daemon=True)
        th.start()
        self._threads[name] = th

    def _supervise(self):
        while self._running:
            for name, (fn, restart) in list(self._loops.items()):
                th = self._threads.get(name)
                if th is not None and not th.is_alive() and \
                        restart and self._running:
                    n = self._restarts[name]
                    delay = min(self._backoff * (2 ** n),
                                self._max_backoff)
                    time.sleep(delay)
                    if not self._running:
                        return
                    self._restarts[name] = n + 1
                    _M_RESTARTS.inc(worker=name)
                    _flight.record("supervisor", "restart",
                                   worker=name, n=n + 1)
                    self._spawn(name, fn)
            time.sleep(self._poll)
