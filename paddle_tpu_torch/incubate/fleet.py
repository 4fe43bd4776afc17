"""The fleet 1.x facade (counterpart: ``paddle_tpu/incubate/fleet.py``;
the reference's ``incubate/fleet/parameter_server/distribute_transpiler``):
``fleet.init(role)``, ``fleet.distributed_optimizer(opt, config)
.minimize(loss)``, then ``init_server``/``run_server`` or
``init_worker``/``main_program``/``stop_worker``.

The roles are the fleet's ``PaddleCloudRoleMaker``, the program split is
``static.DistributeTranspiler`` and the server the native PS service;
this module keeps the legacy call shape only.
"""
from ..distributed.fleet.base.role_maker import PaddleCloudRoleMaker
from ..static.transpiler import (DistributeTranspiler,
                                 DistributeTranspilerConfig)

__all__ = ["fleet", "DistributeTranspilerConfig", "PaddleCloudRoleMaker"]


class _Fleet1x:
    def __init__(self):
        self._role = None
        self._transpiler = None
        self._trainer_prog = None
        self._server_prog = None

    # -- lifecycle (legacy names) ----------------------------------------
    def init(self, role_maker=None):
        self._role = role_maker or PaddleCloudRoleMaker(
            is_collective=False)
        return self

    def is_server(self):
        return self._role.is_server()

    def is_worker(self):
        return self._role.is_worker()

    def worker_index(self):
        return self._role.worker_index()

    def worker_num(self):
        return self._role.worker_num()

    def server_endpoints(self, to_string=False):
        eps = self._role.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    # -- optimizer wrapper (legacy distributed_optimizer) ----------------
    def distributed_optimizer(self, optimizer, strategy=None):
        fleet_self = self

        class _DistributedOptimizer:
            def __init__(self):
                self._inner = optimizer
                self._strategy = strategy or DistributeTranspilerConfig()

            def minimize(self, loss, startup_program=None,
                         parameter_list=None, no_grad_set=None):
                out = self._inner.minimize(loss, startup_program,
                                           parameter_list, no_grad_set)
                t = DistributeTranspiler(config=self._strategy)
                t.transpile(
                    trainer_id=max(fleet_self.worker_index(), 0),
                    pservers=fleet_self.server_endpoints(to_string=True),
                    trainers=fleet_self.worker_num(),
                    sync_mode=getattr(self._strategy, "sync_mode", True))
                fleet_self._transpiler = t
                fleet_self._trainer_prog = t.get_trainer_program()
                return out

        return _DistributedOptimizer()

    # -- server side ------------------------------------------------------
    def init_server(self, *args, **kwargs):
        ep = self._role.get_pserver_endpoints()[
            self._role.server_index()]
        self._server_prog = self._transpiler.get_pserver_program(ep)
        self._server_prog.start()

    def run_server(self):
        self._server_prog.run_server()

    # -- worker side ------------------------------------------------------
    def init_worker(self):
        pass  # the trainer connects to the servers at its first run

    def main_program(self):
        return self._trainer_prog

    def stop_worker(self):
        if self._trainer_prog is not None and \
                self._trainer_prog._ps_ctx is not None:
            self._trainer_prog._ps_ctx.stop()
        # the worker is done: the facade (a module-level object) holds its
        # program, and with it the model's parameters, no longer
        self._trainer_prog = self._transpiler = None


fleet = _Fleet1x()
