"""Monomer gather service (reference
operators/distributed/collective_server.h CollectiveServer +
collective_client.h CollectiveClient::Gather).

Counterpart of ``paddle_tpu/distributed/collective_server.py``, over the
port's RPC transport (``distributed/rpc.py``), whose wire both packages
share: a server or client of either package talks to one of the other.

Each trainer runs a CollectiveServer and publishes named local values
("monomers": dense arrays or SelectedRows (rows, values) pairs); a
gathering trainer pulls the same-named monomer from every rank, rank
order retained.  The reference uses it for a sparse exchange across
trainers without a parameter server; here it is the standalone gather on
the host control plane, beside the process group's collectives.  A
published tensor crosses as the numpy array of its host copy.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from paddle_tpu_torch.core.types import to_numpy
from paddle_tpu_torch.distributed.rpc import (make_rpc_client,
                                               make_rpc_server)

__all__ = ["CollectiveServer", "CollectiveClient"]


def _host(value, name):
    """A value as the wire carries it: numpy (a tensor's host copy, in
    pageable memory: a published monomer lives on)."""
    if hasattr(value, "detach"):
        return to_numpy(value, name, pinned=False)
    return np.asarray(value)


class CollectiveServer:
    def __init__(self, endpoint="127.0.0.1:0"):
        self._server = make_rpc_server(endpoint)
        self.endpoint = self._server.endpoint
        self._vars: dict = {}
        self._cond = threading.Condition()
        self._server.register_handler("get_monomer", self._on_get)
        self._server.register_handler("register_monomer",
                                      self._on_register)
        self._started = False

    # -- server side -------------------------------------------------
    def start(self):
        if not self._started:
            self._server.start()
            self._started = True
        return self

    def register_var(self, name, value, rows=None):
        """Publish a local value (an array or a tensor).  rows!=None
        publishes SelectedRows (reference GetMonomerHandler serves
        SelectedRows)."""
        payload = _host(value, name) if rows is None else \
            (_host(rows, name), _host(value, name))
        with self._cond:
            self._vars[name] = payload
            self._cond.notify_all()

    def _on_register(self, payload):
        # remote registration (tests / cross-process publishers)
        if len(payload) == 3 and payload[2] is not None:
            self.register_var(payload[0], payload[1], rows=payload[2])
        else:
            self.register_var(payload[0], payload[1])

    def _on_get(self, payload):
        name, timeout = payload if isinstance(payload, tuple) \
            else (payload, 60.0)
        with self._cond:
            ok = self._cond.wait_for(lambda: name in self._vars,
                                     timeout=float(timeout))
            if not ok:
                raise TimeoutError(
                    f"monomer '{name}' never registered")
            v = self._vars[name]
        if isinstance(v, tuple):
            return ("selected_rows", v[0], v[1])
        return ("dense", v)

    def wait_var_ready(self, name, timeout=60.0):
        with self._cond:
            return self._cond.wait_for(lambda: name in self._vars,
                                       timeout=timeout)

    def stop(self):
        self._server.stop()


class CollectiveClient:
    """reference CollectiveClient::Gather — rank order retained."""

    def __init__(self):
        self._client = make_rpc_client()

    def gather(self, remote_vars, timeout=60.0):
        """remote_vars: [(endpoint, var_name), ...] in rank order.
        Returns a list of ndarray (dense) or (rows, values) tuples.
        The per-rank pulls run concurrently so the worst-case wait is
        max(rank latency), not the sum (reference
        CollectiveClient::Gather fires all AsyncGetMonomer first)."""

        def one(ep_name):
            ep, name = ep_name
            kind, *rest = self._client.call(ep, "get_monomer",
                                            (name, float(timeout)))
            return tuple(rest) if kind == "selected_rows" else rest[0]

        with ThreadPoolExecutor(
                max_workers=max(1, len(remote_vars))) as pool:
            return list(pool.map(one, remote_vars))

    def close(self):
        self._client.close()
