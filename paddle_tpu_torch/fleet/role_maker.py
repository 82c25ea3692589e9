"""Role makers: who am I in the cluster?

Counterpart of ``paddle_tpu/fleet/role_maker.py``, the same env-var
contract, so reference cluster launchers port unchanged.

Reference parity: python/paddle/fluid/incubate/fleet/base/role_maker.py
(RoleMakerBase, PaddleCloudRoleMaker reading PADDLE_TRAINER_ID /
PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ENDPOINTS / PADDLE_CURRENT_ENDPOINT,
UserDefinedRoleMaker).
"""

from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._trainer_id = 0
        self._trainers_num = 1
        self._trainer_endpoints = []
        self._current_endpoint = ""
        self._role = Role.WORKER
        self._generated = False

    def generate_role(self):
        self._generated = True

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._trainer_id == 0

    def worker_index(self):
        return self._trainer_id

    def worker_num(self):
        return self._trainers_num

    def get_trainer_endpoints(self):
        return list(self._trainer_endpoints)

    def get_current_endpoint(self):
        return self._current_endpoint

    def get_pserver_endpoints(self):
        return list(getattr(self, "_server_endpoints", []))


class PaddleCloudRoleMaker(RoleMakerBase):
    """reference role_maker.py PaddleCloudRoleMaker: env-var driven."""

    def __init__(self, is_collective=True):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        self._trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._trainers_num = int(
            os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = [e for e in eps.split(",") if e]
        self._current_endpoint = os.environ.get(
            "PADDLE_CURRENT_ENDPOINT",
            self._trainer_endpoints[self._trainer_id]
            if self._trainer_id < len(self._trainer_endpoints) else "")
        training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self._role = Role.SERVER if training_role == "PSERVER" \
            else Role.WORKER
        ps_eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in ps_eps.split(",") if e]
        self._generated = True


class UserDefinedRoleMaker(RoleMakerBase):
    """reference role_maker.py UserDefinedRoleMaker."""

    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, worker_endpoints=None):
        super().__init__()
        self._trainer_id = current_id
        self._role = role
        self._trainers_num = worker_num
        self._trainer_endpoints = worker_endpoints or []
        self._server_endpoints = server_endpoints or []
        if self._trainer_endpoints and \
                current_id < len(self._trainer_endpoints):
            self._current_endpoint = self._trainer_endpoints[current_id]

    def generate_role(self):
        self._generated = True
