"""RoleMakers (counterpart: ``paddle_tpu/distributed/fleet/base/
role_maker.py``; the reference framework's `fleet/base/role_maker.py:359/
530/903`).

Rank and endpoints come from the launcher's environment (the
``PADDLE_TRAINER_*`` / ``TRAINING_ROLE`` / ``PADDLE_PSERVER_ENDPOINTS``
contract). Where the environment is silent, a worker's index and count are
the ``torch.distributed`` group's rank and world when a group is up (the
reference reads ``jax.process_index()``/``process_count()`` there), else 0
and 1.
"""
import os

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


def _process_rank_world():
    """(rank, world) of the ``torch.distributed`` group, (0, 1) without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._is_collective = True

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        return _process_rank_world()[0]

    def worker_num(self):
        return _process_rank_world()[1]

    def get_trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else ["127.0.0.1:0"]

    # -- parameter-server roles (reference: role_maker.py TRAINING_ROLE /
    # PADDLE_PSERVER_ENDPOINTS contract) ----------------------------------
    def get_pserver_endpoints(self):
        eps = os.environ.get("PADDLE_PSERVER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    def server_index(self):
        return int(os.environ.get("PADDLE_PSERVER_ID", "0"))

    def server_num(self):
        return len(self.get_pserver_endpoints())


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        super().__init__()
        self._is_collective = is_collective

    def is_server(self):
        return os.environ.get("TRAINING_ROLE", "TRAINER") == "PSERVER"

    def is_worker(self):
        return not self.is_server()

    def worker_index(self):
        if "PADDLE_TRAINER_ID" in os.environ:
            return int(os.environ["PADDLE_TRAINER_ID"])
        return _process_rank_world()[0]

    def worker_num(self):
        if "PADDLE_TRAINERS_NUM" in os.environ:
            return int(os.environ["PADDLE_TRAINERS_NUM"])
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS")
        if eps:
            return len(eps.split(","))
        return _process_rank_world()[1]


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, current_id=0, role=Role.WORKER,
                 worker_num=1, server_endpoints=None, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = list(server_endpoints or [])

    def is_server(self):
        return self._role == Role.SERVER

    def is_worker(self):
        return self._role == Role.WORKER

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)
