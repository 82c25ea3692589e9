"""FleetWrapper — the worker-side sparse/dense table verbs.

Counterpart of ``paddle_tpu/fleet/fleet_wrapper.py``: the same verbs
against the same RPC messages of the port's parameter server
(``listen_and_serv`` table shards and async grad blocks over
``distributed/rpc.py``), so it drives a pserver of either package.
Values cross as host numpy arrays; the caller places what it pulls.
``DownpourRunner`` composes these verbs into its per-batch pull, train,
push loop, as DownpourWorker composes the reference's.

Reference parity: framework/fleet/fleet_wrapper.h:55 PullSparseVarsSync,
:62 PushSparseVarsWithLabelAsync, :95 PullDenseVarsAsync (the
reference's wrapper bridges to Baidu's closed pslib server).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FleetWrapper"]


class FleetWrapper:
    def __init__(self, transpiler, client=None):
        from paddle_tpu_torch.distributed.rpc import make_rpc_client

        self.t = transpiler
        self.eps = list(transpiler.endpoints)
        self.client = client or make_rpc_client()

    # ------------------------------------------------------- sparse
    def _table_rows(self, table_name):
        shape = self.t.origin_program.global_block().var(
            table_name).shape
        return int(shape[0])

    def pull_sparse_rows_sync(self, table_name, ids):
        """Pull the table rows for `ids` (int64) from their owning
        shards; returns (valid_ids, values) row-aligned — ids outside
        [0, table_rows) (OOV / -1 padding) are dropped, matching the
        worker semantics of leaving their fill-buffer rows untouched
        (reference PullSparseVarsSync)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        n_rows = self._table_rows(table_name)
        ids = ids[(ids >= 0) & (ids < n_rows)]
        if ids.size == 0:
            return ids, np.zeros((0,), np.float32)
        plan = self.t.dist_tables[table_name]
        vals = None
        for ep_i, sec, s, e in plan:
            hi = n_rows if e == -1 else min(e, n_rows)
            m = (ids >= s) & (ids < hi)
            if not m.any():
                continue
            rows = np.asarray(self.client.call(
                self.eps[ep_i], "prefetch_rows",
                (sec, (ids[m] - s).astype(np.int64))))
            if vals is None:
                vals = np.zeros((ids.size,) + rows.shape[1:],
                                rows.dtype)
            vals[m] = rows
        if vals is None:
            raise KeyError(
                f"no shard of '{table_name}' covered any of the ids")
        return ids, vals

    def push_sparse_grad_sync(self, table_name, rows, values):
        """Push sparse (rows, values) grads to their owning shards;
        the async PS applies them on arrival (reference
        PushSparseVarsWithLabelAsync minus the pslib click/CVM columns
        of the closed table format)."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        values = np.asarray(values)
        n_rows = self._table_rows(table_name)
        keep = (rows >= 0) & (rows < n_rows)
        rows, values = rows[keep], values[keep]
        for ep_i, sec, s, e in self.t.dist_tables[table_name]:
            hi = n_rows if e == -1 else min(e, n_rows)
            m = (rows >= s) & (rows < hi)
            if not m.any():
                continue
            gsec = self.t._grad_section_name(table_name, sec)
            self.client.call(
                self.eps[ep_i], "send_sparse",
                (gsec, np.ascontiguousarray(rows[m] - s),
                 np.ascontiguousarray(values[m])))

    # -------------------------------------------------------- dense
    def pull_dense_vars_sync(self):
        """{param: value} assembled from every param's shards
        (reference PullDenseVarsAsync + PullDenseWorker's wait)."""
        out = {}
        for pname, plan in self.t.param_plan.items():
            # trainer_idx lets a DC-ASGD pserver re-snapshot this
            # trainer's param backup at pull time (on_get_var)
            parts = [np.asarray(self.client.get_var(
                self.eps[ep_i], sec,
                trainer_idx=int(self.t.trainer_id)))
                for ep_i, sec, _s, _e in plan]
            out[pname] = parts[0] if len(parts) == 1 else \
                np.concatenate(parts, axis=0)
        return out

    def push_dense_grad_sync(self, pname, grad):
        """Push one dense param's grad sections (reference
        PushDenseVarsAsync; callers wanting async wrap this in their
        own pool — DownpourRunner's bounded window does)."""
        g = np.asarray(grad)
        for ep_i, sec, s, e in self.t.param_plan[pname]:
            gsec = self.t._grad_section_name(pname, sec)
            part = g if (s == 0 and e == -1) else g[s:e]
            self.client.send_var(self.eps[ep_i], gsec,
                                 np.ascontiguousarray(part),
                                 trainer_idx=int(self.t.trainer_id))

    def stop(self):
        self.client.close()
