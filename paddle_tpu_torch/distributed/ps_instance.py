"""Process-role bookkeeping for PS clusters.

Counterpart of ``paddle_tpu/distributed/ps_instance.py``: the same role
arithmetic on PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM (or explicit
constructor arguments).  ``gather_ips``, ``barrier_all`` and
``barrier_worker`` call the ``gather_ip``, ``barrier_all`` and
``barrier_worker`` RPCs of the server at PADDLE_BARRIER_ENDPOINT, as the
JAX package does; no server of either package registers them (ROADMAP
Queue 3), and without that endpoint they are no-ops, like mpirun -np 1.

Reference parity: python/paddle/fluid/distributed/ps_instance.py:17
PaddlePSInstance (rank and size from MPI there).
"""

from __future__ import annotations

import os

__all__ = ["PaddlePSInstance"]


class PaddlePSInstance:
    """reference ps_instance.py:17; node_type: -1 idle, 0 server,
    1 worker."""

    def __init__(self, server_worker_mode=1, proc_per_node=2, nodes=None,
                 rankid=None):
        if server_worker_mode == 1 and (proc_per_node < 2
                                        or proc_per_node % 2):
            raise ValueError(
                "interleaved mode (server_worker_mode=1) needs an even "
                f"proc_per_node >= 2, got {proc_per_node}")
        self._rankid = int(os.getenv("PADDLE_TRAINER_ID", 0)) \
            if rankid is None else int(rankid)
        self._server_worker_mode = server_worker_mode
        self._proc_per_node = proc_per_node
        self._nodes = int(os.getenv("PADDLE_NODES",
                                    os.getenv("PADDLE_TRAINERS_NUM", 1))) \
            if nodes is None else int(nodes)
        self._ip = 0
        self._worker_num = self._nodes * self._proc_per_node // 2
        self._server_num = self._nodes * self._proc_per_node // 2
        self._total_server_worker = self._worker_num + self._server_num
        self._node_type = None
        self._set_nodetype()
        self._barrier_endpoint = os.getenv("PADDLE_BARRIER_ENDPOINT")

    def _set_nodetype(self):
        if self._server_worker_mode == 0:
            # first block of ranks are workers, next are servers
            if self._rankid < self._server_num:
                self._node_type = 1
            elif self._rankid < self._total_server_worker:
                self._node_type = 0
            else:
                self._node_type = -1
        elif self._server_worker_mode == 1:
            # interleaved: even local rank = server, odd = worker
            if self._rankid < self._total_server_worker:
                if self._rankid % self._proc_per_node % 2 == 0:
                    self._node_type = 0
                else:
                    self._node_type = 1
            else:
                self._node_type = -1
        else:
            self._node_type = -1

    def get_worker_index(self):
        if self._server_worker_mode == 0:
            # block mode: workers occupy ranks [0, worker_num)
            return self._rankid
        # interleaved: odd local ranks are workers; number the workers
        # below us (node * per-node workers + our position on the node)
        node = self._rankid // self._proc_per_node
        local = self._rankid % self._proc_per_node
        return node * (self._proc_per_node // 2) + (local - 1) // 2

    def get_server_index(self):
        if self._server_worker_mode == 0:
            # block mode: servers occupy ranks [worker_num, total)
            return self._rankid - self._worker_num
        node = self._rankid // self._proc_per_node
        local = self._rankid % self._proc_per_node
        return node * (self._proc_per_node // 2) + local // 2

    def is_worker(self):
        return self._node_type == 1

    def is_server(self):
        return self._node_type == 0

    def is_first_worker(self):
        return self.is_worker() and self.get_worker_index() == 0

    def set_ip(self, ip):
        self._ip = ip

    def gather_ips(self):
        """All-gather of set_ip values.  With an RPC barrier endpoint the
        server aggregates; standalone returns just our own ip."""
        if self._barrier_endpoint:
            from paddle_tpu_torch.distributed.rpc import global_rpc_client

            client = global_rpc_client()
            self._ips = client.call(self._barrier_endpoint, "gather_ip",
                                    (self._rankid, self._ip))
        else:
            self._ips = [self._ip]
        return self._ips

    def get_node_cnt(self):
        return self._nodes

    def get_worker_num(self):
        return self._worker_num

    def get_server_num(self):
        return self._server_num

    def barrier_all(self):
        if self._barrier_endpoint:
            from paddle_tpu_torch.distributed.rpc import global_rpc_client

            global_rpc_client().call(self._barrier_endpoint, "barrier_all",
                                     self._rankid)

    def barrier_worker(self):
        if self.is_worker():
            if self._barrier_endpoint:
                from paddle_tpu_torch.distributed.rpc import global_rpc_client

                global_rpc_client().call(self._barrier_endpoint,
                                         "barrier_worker",
                                         self.get_worker_index())

    def finalize(self):
        """Nothing to tear down (the RPC client caches close at exit)."""
