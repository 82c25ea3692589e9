"""Async Communicator: background grad-send / param-recv threads for
fully-async parameter-server training.

Counterpart of ``paddle_tpu/communicator.py``, with the same failure
semantics:
  - the send/recv loops run under a guard that reports any escaped
    exception into an error queue (errors()) instead of dying silently;
  - a supervisor thread restarts a dead worker with exponential backoff;
  - per-var queues are BOUNDED (backpressure: a producer outrunning a
    wedged sender blocks in put() instead of growing without bound);
  - stop() drains EVERY queued grad to the pservers before returning.

The trainer pushes grads with put() (non-blocking up to the queue
bound): a tensor is copied to the host there, on the caller's thread,
into pageable memory (``core/types.to_numpy(pinned=False)``
synchronises), so the send thread only sees numpy arrays.  The send
thread merges up to ``max_merge_var_num`` queued grads per var (mean)
and ships their sections to the pservers; the recv thread pulls the
params every ``recv_interval``.  Each thread has an RPC client of its
own: on one shared connection a sender busy with a large model's grads
starves the receiver of the connection's lock.  The recv thread never
writes into a tensor the executor may be reading: it copies each
parameter into a fresh tensor on the scope's device, on a side stream
of its own, synchronises that stream so the copy is complete, and only
then swaps the tensor into the ``Variable``.  ``recv_round_s`` keeps
each complete round's seconds.  The bounded-queue and
supervised-worker machinery is ``concurrency.py``'s.

Reference parity: the C++ Communicator SendThread/RecvThread with
per-var queues and merge-before-send
(paddle/fluid/operators/distributed/communicator.h:160-184) and
python/paddle/fluid/communicator.py.
"""

from __future__ import annotations

import queue as queue_mod
import time

import numpy as np
import torch

from paddle_tpu_torch.concurrency import BoundedQueue, Supervisor
from paddle_tpu_torch.core.types import from_numpy, to_numpy
from paddle_tpu_torch.distributed.rpc import make_rpc_client
from paddle_tpu_torch.observability import metrics as _obs_metrics

_M_EVENTS = _obs_metrics.counter(
    "paddle_tpu_communicator_events_total",
    "async-communicator transitions (grads_sent / recv_rounds / "
    "flush_errors), by event")


class Communicator:
    def __init__(self, transpiler, scope, max_merge_var_num=20,
                 send_wait_times=0.005, recv_interval=0.02,
                 max_queue_per_var=0, restart_backoff=0.1):
        """transpiler: a transpiled DistributeTranspiler (source of the
        section plan); scope: where received params land, on the device
        of the param already there (the CPU when it has none).
        max_queue_per_var: put() backpressure bound (0 -> 8x
        max_merge_var_num); restart_backoff: first supervisor restart
        delay (doubles per consecutive restart, capped at 2s)."""
        self._t = transpiler
        self._scope = scope
        self._max_merge = max_merge_var_num
        self._send_wait = send_wait_times
        self._recv_interval = recv_interval
        self._max_queue = int(max_queue_per_var) or 8 * max_merge_var_num
        self._queues = {g: BoundedQueue(maxsize=self._max_queue)
                        for g in (transpiler.grad_of[p]
                                  for p in transpiler.param_plan)}
        self._grad_to_param = {g: p
                               for p, g in transpiler.grad_of.items()}
        self._streams = {}
        self._send_client = make_rpc_client()
        self._recv_client = make_rpc_client()
        self.recv_round_s = []
        self._sup = Supervisor(restart_backoff=restart_backoff,
                               max_backoff=2.0)
        self._sup.add_worker("send", self._send_loop)
        self._sup.add_worker("recv", self._recv_loop)

    @property
    def _running(self):
        return self._sup.running

    # -- trainer-facing -----------------------------------------------------
    def put(self, grad_name, value, block=True, timeout=None):
        """Queue a grad for the send thread.  Blocks when the per-var
        queue is full (backpressure) unless block=False (raises
        queue.Full)."""
        q = self._queues.get(grad_name)
        if q is None:
            raise KeyError(f"Communicator: unknown grad '{grad_name}'")
        value = to_numpy(value, grad_name, pinned=False) \
            if isinstance(value, torch.Tensor) else np.asarray(value)
        q.put(value, block=block, timeout=timeout)

    def start(self):
        self._sup.start()
        return self

    def stop(self):
        self._sup.stop(join_timeout=5.0)
        self._flush()
        self._send_client.close()
        self._recv_client.close()

    def errors(self):
        """Every exception a worker thread reported (name, exc), oldest
        first; empty when the communicator has been healthy."""
        return self._sup.errors()

    def restarts(self):
        return self._sup.restarts()

    # -- internals ----------------------------------------------------------
    def _merge(self, vals):
        return vals[0] if len(vals) == 1 else \
            np.mean(np.stack(vals), axis=0)

    def _send_grad(self, gname, merged):
        client = self._send_client
        pname = self._grad_to_param[gname]
        plan = self._t.param_plan[pname]
        for i, sec, s, e in plan:
            gsec = self._t._grad_section_name(pname, sec)
            part = merged if (s == 0 and e == -1) else merged[s:e]
            client.send_var(self._t.endpoints[i], gsec,
                            np.ascontiguousarray(part),
                            trainer_idx=int(self._t.trainer_id))
        _M_EVENTS.inc(event="grads_sent")

    def _flush(self):
        """Drain EVERY queued grad (not just one merge window per var):
        short jobs stop() right after their last put(), and abandoning
        the tail silently loses updates the pserver never saw."""
        for gname, q in self._queues.items():
            while True:
                vals = q.drain(self._max_merge)
                if not vals:
                    break
                try:
                    self._send_grad(gname, self._merge(vals))
                except Exception as e:
                    # endpoint gone at shutdown: record, stop trying
                    # this var (the remaining items would fail the same
                    # way), keep flushing the others
                    self._sup.report_error("flush", e)
                    _M_EVENTS.inc(event="flush_errors")
                    break

    def _send_loop(self):
        while self._running:
            sent_any = False
            for gname, q in self._queues.items():
                vals = q.drain(self._max_merge)
                if not vals:
                    continue
                try:
                    self._send_grad(gname, self._merge(vals))
                except Exception:
                    # requeue before dying: the supervisor restarts the
                    # loop and these updates ship late instead of never
                    for v in vals:
                        try:
                            q.put_nowait(v)
                        except queue_mod.Full:
                            break
                    raise
                sent_any = True
            if not sent_any:
                time.sleep(self._send_wait)

    def _place(self, pname, val):
        """``val`` as a fresh tensor where the scope keeps ``pname``,
        complete before it is returned."""
        cur = self._scope.find_var(pname)
        cur = None if cur is None else cur.get()
        device = cur.device if isinstance(cur, torch.Tensor) \
            else torch.device("cpu")
        host = from_numpy(val, pname)
        if device.type != "cuda":
            return host.clone()
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            out = host.to(device)
        stream.synchronize()
        # allocated on the side stream: its memory returns to that pool
        # only once the executor's work on it is done
        out.record_stream(torch.cuda.default_stream(device))
        return out

    def _recv_loop(self):
        client = self._recv_client
        while self._running:
            t0 = time.perf_counter()
            for pname, plan in self._t.param_plan.items():
                try:
                    parts = [client.get_var(
                        self._t.endpoints[i], sec,
                        trainer_idx=int(self._t.trainer_id))
                        for i, sec, *_ in plan]
                except Exception:
                    continue
                val = parts[0] if len(parts) == 1 else \
                    np.concatenate(parts, axis=0)
                self._scope.var(pname).set(self._place(pname, val))
            self.recv_round_s.append(time.perf_counter() - t0)
            _M_EVENTS.inc(event="recv_rounds")
            time.sleep(self._recv_interval)
