"""The Downpour async worker loop.

Counterpart of ``paddle_tpu/distributed/downpour_worker.py``.  Per batch
the worker

  1. PULLS the batch's sparse rows from the PS table shards into its
     local table (reference PullSparseVarsSync + FillSparseValue),
  2. runs forward and backward on its executor's device — optimizer ops
     are NOT run, the parameter server owns every update,
  3. PUSHES sparse and dense gradients asynchronously with a bounded
     in-flight window (the staleness knob the reference expresses as
     push_{sparse,dense}_wait_times), and
  4. refreshes dense params from the PS every ``pull_dense_every``
     batches (PullDenseWorker semantics: params are at most that many
     steps stale).

Each table lives in one device buffer of vocab x dim: the pulled rows
are scattered into it with ``index_copy_`` (on the executor's stream,
before the step that reads them), and the table's gradient rows of the
batch are gathered on the device before their copy to the host, so a
step moves the batch's rows each way, never the whole table.  Every
host copy is made on the caller's thread (``core/types.to_numpy``
synchronises the stream); the push threads only see numpy arrays.  A
pulled dense parameter becomes a fresh device tensor set into the
scope.  The runner's executor is ``Executor()``, the card, unless the
caller passes one (the JAX package's default is the CPU).

``stats`` sums, over the steps run, the caller-thread seconds of the
pulls, the compute (``Executor.run``, ending in its fetch) and the
pushes (the grads' host copies and the waits for the window), and the
bytes each way.

Reference parity: framework/downpour_worker.cc:369 DownpourWorker::
TrainFiles; framework/fleet/fleet_wrapper.h:55 PullSparseVarsSync, :62
PushSparseVarsWithLabelAsync, :95 PullDenseVarsAsync; plus
framework/pull_dense_worker.cc's periodic dense refresh.  The PS side is
the ordinary async-mode ``listen_and_serv`` program built by
``DistributeTranspiler`` (grads applied on arrival, sparse blocks per
table section).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from paddle_tpu_torch.core.types import from_numpy, to_numpy, to_torch_dtype

__all__ = ["DownpourRunner"]

_STATS = ("steps", "pull_s", "compute_s", "push_s", "pulled_bytes",
          "pushed_bytes")


def _host(value, name):
    return to_numpy(value, name) if isinstance(value, torch.Tensor) \
        else np.asarray(value)


class DownpourRunner:
    def __init__(self, transpiler, program=None, scope=None,
                 executor=None, push_window=4, pull_dense_every=1):
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.program import OPTIMIZE
        from paddle_tpu_torch.core.scope import global_scope
        from paddle_tpu_torch.distributed.rpc import (make_rpc_client,
                                                       start_shared_heartbeat)
        from paddle_tpu_torch.fleet.fleet_wrapper import FleetWrapper

        t = transpiler
        if not t.endpoints:
            raise ValueError("transpiler has no pserver endpoints")
        self.t = t
        self.eps = list(t.endpoints)
        self.scope = scope if scope is not None else global_scope()
        self.exe = executor if executor is not None else Executor()
        self.device = self.exe.device
        prog = program if program is not None else t.origin_program
        # local worker program: fwd + bwd only (the PS runs optimizers)
        self.worker_prog = prog.clone()
        gb = self.worker_prog.global_block()
        gb.ops = [op for op in gb.ops if op.op_role != OPTIMIZE]
        # sparse tables -> the id slots their lookups consume
        self.table_ids: dict = {}
        for op in gb.ops:
            if op.type == "lookup_table" and \
                    op.inputs["W"][0] in t.dist_tables:
                self.table_ids.setdefault(
                    op.inputs["W"][0], []).extend(op.inputs["Ids"])
        # one device buffer a table (reference FillSparseValue target):
        # dist tables never initialize on non-zero trainers, and only
        # the pulled rows are ever read, so zeros are the right start
        self._table_buf: dict = {}
        self._batch_rows: dict = {}
        for wname in self.table_ids:
            var = self.scope.find_var(wname)
            if var is not None and var.get() is not None:
                buf = var.get().detach().to(self.device).clone()
            else:
                v = gb.var(wname)
                buf = torch.zeros(tuple(v.shape), device=self.device,
                                  dtype=to_torch_dtype(v.dtype or "float32"))
            self._table_buf[wname] = buf
            self.scope.var(wname).set(buf)
        self.push_window = int(push_window)
        self.pull_dense_every = max(1, int(pull_dense_every))
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._pending: deque = deque()
        self._batch = 0
        self._lock = threading.Lock()
        self.stats = dict.fromkeys(_STATS, 0)
        self.results = []
        # dedicated clients: pushes must never block pulls on a
        # connection lock (reference: separate push status queues);
        # the table verbs themselves live in FleetWrapper
        self._pull_client = make_rpc_client()
        self._push_client = make_rpc_client()
        self._fleet_pull = FleetWrapper(t, client=self._pull_client)
        self._fleet_push = FleetWrapper(t, client=self._push_client)
        # liveness: announce this worker so pserver barriers and
        # completions account for it (listen_and_serv effective_fanin)
        interval = float(getattr(t.config, "heartbeat_interval", 1.0))
        for ep in self.eps:
            start_shared_heartbeat(ep, f"trainer{t.trainer_id}",
                                   interval=interval)

    # ----------------------------------------------------------- dense
    def pull_dense(self):
        """Refresh every dense param from its PS shards (reference
        PullDenseVarsAsync / pull_dense_worker.cc): a fresh device
        tensor each, swapped into the scope."""
        for pname, val in self._fleet_pull.pull_dense_vars_sync().items():
            self.stats["pulled_bytes"] += val.nbytes
            self.scope.var(pname).set(from_numpy(val, pname).to(self.device))

    def _push_dense(self):
        """Async dense-grad push (reference PushDenseVarsAsync)."""
        for pname in self.t.param_plan:
            gname = self.t.grad_of.get(pname)
            if gname is None:
                continue
            gvar = self.scope.find_var(gname)
            if gvar is None or gvar.get() is None:
                continue
            g = _host(gvar.get(), gname)
            self.stats["pushed_bytes"] += g.nbytes
            self._submit(lambda p=pname, v=g:
                         self._fleet_push.push_dense_grad_sync(p, v))

    # ---------------------------------------------------------- sparse
    def _pull_sparse(self, feed):
        """Pull the batch's rows into the table's device buffer
        (reference PullSparseVarsSync + FillSparseValue)."""
        self._batch_rows = {}
        for wname, slots in self.table_ids.items():
            chunks = [_host(feed[s], s).ravel() for s in slots if s in feed]
            if not chunks:
                continue
            ids = np.unique(np.concatenate(chunks).astype(np.int64))
            if ids.size == 0:
                continue
            ids, vals = self._fleet_pull.pull_sparse_rows_sync(wname, ids)
            self.stats["pulled_bytes"] += ids.nbytes + vals.nbytes
            self._batch_rows[wname] = ids
            if ids.size == 0:
                continue
            buf = self._table_buf[wname]
            buf.index_copy_(0, torch.from_numpy(ids).to(self.device),
                            from_numpy(vals, wname).to(self.device,
                                                       dtype=buf.dtype))

    def _push_sparse(self):
        """Async sparse-grad push of the rows the batch touched
        (reference PushSparseVarsWithLabelAsync, minus the pslib
        click/CVM columns which belong to the closed table format)."""
        for wname in self.table_ids:
            gname = wname + "@GRAD"
            gvar = self.scope.find_var(gname)
            if gvar is None or gvar.get() is None:
                continue
            g = gvar.get()
            if hasattr(g, "rows"):          # SelectedRows
                rows = _host(g.rows, gname).astype(np.int64)
                vals = _host(g.values, gname)
            else:                            # dense grad: the batch's rows
                rows = self._batch_rows.get(wname)
                if rows is None:
                    continue
                vals = to_numpy(torch.index_select(
                    g, 0, torch.from_numpy(rows).to(g.device)), gname)
            self.stats["pushed_bytes"] += rows.nbytes + vals.nbytes
            self._submit(lambda w=wname, r=rows, v=vals:
                         self._fleet_push.push_sparse_grad_sync(w, r, v))

    # ------------------------------------------------------- lifecycle
    def _submit(self, fn):
        """Bounded-staleness async push: at most push_window in-flight
        (reference push_*_wait_times; a full window waits the oldest)."""
        with self._lock:
            while len(self._pending) >= self.push_window:
                self._pending.popleft().result()
            self._pending.append(self._pool.submit(fn))

    def drain(self):
        with self._lock:
            while self._pending:
                self._pending.popleft().result()

    def run_step(self, feed, fetch_list=()):
        """One Downpour batch: pull -> compute -> async push."""
        t0 = time.perf_counter()
        if self._batch % self.pull_dense_every == 0:
            self.drain()      # pushed grads land before the re-pull
            self.pull_dense()
        self._pull_sparse(feed)
        t1 = time.perf_counter()
        res = self.exe.run(self.worker_prog, feed=feed,
                           fetch_list=list(fetch_list), scope=self.scope)
        t2 = time.perf_counter()
        self._push_sparse()
        self._push_dense()
        t3 = time.perf_counter()
        self._batch += 1
        st = self.stats
        st["steps"] += 1
        st["pull_s"] += t1 - t0
        st["compute_s"] += t2 - t1
        st["push_s"] += t3 - t2
        return res

    def reset_stats(self):
        self.stats = dict.fromkeys(_STATS, 0)

    def train_from_dataset(self, dataset, fetch_list=()):
        """Dataset-driven Downpour loop (reference TrainFiles: while
        device_reader->Next()); the steps' fetches, also kept as
        ``results``."""
        self.results = []
        for feed in dataset._iter_batches():
            self.results.append(self.run_step(feed, fetch_list))
        self.drain()
        return self.results

    def finish(self):
        self.drain()
        self._pool.shutdown(wait=True)
        self._pull_client.close()
        self._push_client.close()
