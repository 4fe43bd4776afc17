"""The parameter-server transpiler (counterpart:
``paddle_tpu/static/transpiler.py``; the reference's
``transpiler/distribute_transpiler.py:256``).

``DistributeTranspiler.transpile`` splits a Program that has an optimizer
into a trainer half and server halves. The trainer half is the same
Program with a trainer context: the Executor replays it and runs its
backward as one ``jit.to_static`` program (one CUDA graph on the card),
whose outputs are the fetches and the trainable parameters' gradients;
then the gradients go to the port's native PS service and the fresh
parameters come back, through the same communicators as the dygraph PS
path (push ``g / n_trainers``, barrier, pull, barrier in sync mode). The
optimizer's rule runs on the servers (``sgd`` or ``adam`` tables), so
the local optimizer is detached. A server half (:class:`PsServerProgram`)
holds one dense table a trainable parameter (table ids in slot order, so
every trainer derives the same ids).
"""
import warnings
import weakref

import torch

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "PsServerProgram"]


class DistributeTranspilerConfig:
    """The transpiler's knobs. Tables are whole parameters (one per
    server in turn), not blocks, so ``slice_var_up`` and
    ``min_block_size`` are recorded and warn once when changed."""

    _warned = False

    def __init__(self):
        self._slice_var_up = True
        self._min_block_size = 8192
        self.mode = "pserver"

    @staticmethod
    def _warn_noop(name):
        if not DistributeTranspilerConfig._warned:
            DistributeTranspilerConfig._warned = True
            warnings.warn(
                f"DistributeTranspilerConfig.{name} has no effect here: "
                "each parameter is one table, not block-sliced, so "
                "slice_var_up/min_block_size are accepted for the "
                "reference's signature only", UserWarning, stacklevel=3)

    @property
    def slice_var_up(self):
        return self._slice_var_up

    @slice_var_up.setter
    def slice_var_up(self, v):
        if bool(v) != self._slice_var_up:
            self._warn_noop("slice_var_up")
        self._slice_var_up = bool(v)

    @property
    def min_block_size(self):
        return self._min_block_size

    @min_block_size.setter
    def min_block_size(self, v):
        if int(v) != self._min_block_size:
            self._warn_noop("min_block_size")
        self._min_block_size = int(v)


def _server_rule(opt):
    """The program's optimizer as a server table rule."""
    from ..optimizer import SGD, Adam, AdamW
    if opt._lr.scheduler is not None:
        raise NotImplementedError(
            "DistributeTranspiler: an LRScheduler cannot be transpiled; the "
            "server table applies a constant rate, which would freeze the "
            "schedule. Pass a float learning_rate")
    lr = float(opt._lr.value())
    if isinstance(opt, AdamW):
        raise NotImplementedError(
            "DistributeTranspiler: AdamW's decoupled weight decay has no "
            "server-side table rule (the PS tables apply sgd/adam); use Adam "
            "or SGD for transpiled programs")
    if isinstance(opt, Adam):
        return "adam", dict(lr=lr, beta1=opt._beta1, beta2=opt._beta2,
                            eps=opt._eps)
    if isinstance(opt, SGD):
        return "sgd", dict(lr=lr)
    raise NotImplementedError(
        f"DistributeTranspiler: no server-side rule for "
        f"{type(opt).__name__} (the native PS tables implement sum/sgd/adam)")


class PsServerProgram:
    """A server half: its tables and endpoint; :meth:`run_server` serves
    until a client sends STOP (``listen_and_serv``)."""

    def __init__(self, endpoint, tables):
        self.endpoint = endpoint
        self.tables = tables
        self.server = None

    def start(self):
        from ..distributed.ps import PsServer
        port = int(self.endpoint.rsplit(":", 1)[1])
        self.server = PsServer(self.tables, port=port)
        return self.server.start()

    def run_server(self):
        if self.server is None:
            self.start()
        self.server.run()


class _PsTrainerCtx:
    """The Executor's side of a transpiled trainer program."""

    def __init__(self, prog, trainer_id, endpoints, n_trainers, sync_mode):
        self._prog = weakref.ref(prog)  # the program holds this context
        self.trainer_id = trainer_id
        self.endpoints = endpoints
        self.n_trainers = n_trainers
        self.sync_mode = sync_mode
        self.client = None
        self.comm = None
        self._steps = {}
        self.train_slots = [
            s for s in sorted(prog.params)
            if isinstance(prog.params[s], torch.nn.Parameter)
            and prog.params[s].requires_grad]

    def _ensure_client(self):
        if self.comm is None:
            from ..distributed.ps import PsClient
            from ..distributed.ps.communicator import (AsyncCommunicator,
                                                       SyncCommunicator)
            self.client = PsClient(self.endpoints)
            cls = SyncCommunicator if self.sync_mode else AsyncCommunicator
            self.comm = cls(self.client, n_workers=self.n_trainers)
            prog = self._prog()
            for tid, s in enumerate(self.train_slots):
                self.comm.register_dense_param(tid, prog.params[s])
            self.comm.init_params()  # worker 0's values, then aligned

    def _build(self, prog, feed_slots, fetch_slots):
        from ..jit.to_static import to_static
        loss_slot = prog._loss_slot
        params = [prog.params[s] for s in self.train_slots]
        prog_ref = weakref.ref(prog)

        def grad_step(*feeds):
            prog = prog_ref()
            env = prog._env()
            env.update(zip(feed_slots, feeds))
            prog._replay(env)
            loss = env[loss_slot]
            (loss if loss.dim() == 0 else loss.sum()).backward()
            grads = tuple(torch.zeros_like(p) if p.grad is None
                          else p.grad.detach() for p in params)
            for p in params:
                p.grad = None
            return tuple(env[s].detach() for s in fetch_slots), grads

        grad_step.__name__ = "transpiled_trainer_step"
        return to_static(grad_step)

    def run_step(self, exe, prog, feed, fetch_list, return_numpy):
        from .program import _feed_tensor, _host
        self._ensure_client()
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        names = sorted(n for n in feed if n not in prog._pruned_feeds)
        feed_slots = [prog.feed_vars[n][0] for n in names]
        vals = [_feed_tensor(feed[n], prog.feed_vars[n][2], exe.device)
                for n in names]
        fetch_slots = [prog._slot_of(v, create=False) for v in fetch_list]
        key = (tuple(names), tuple(tuple(v.shape) for v in vals),
               tuple(fetch_slots))
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = self._build(prog, feed_slots,
                                                  fetch_slots)
        fetched, grads = step(*vals)
        for s, g in zip(self.train_slots, grads):
            prog.params[s].grad = g
        self.comm.step()  # push (/n in sync mode), barrier, pull, barrier
        return [_host(v, return_numpy) for v in fetched]

    def stop(self):
        if self.comm is not None:
            self.comm.stop()
        if self.client is not None:
            if self.trainer_id == 0:
                self.client.stop_servers()
            self.client.close()


class DistributeTranspiler:
    """``transpile`` splits the program; ``get_trainer_program``,
    ``get_pserver_program(s)`` and ``get_startup_program`` are the
    reference's legacy API."""

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._trainer_prog = None
        self._tables = None
        self._endpoints = None

    def transpile(self, trainer_id, program=None, pservers="",
                  trainers=1, sync_mode=True, startup_program=None):
        from ..distributed.ps import TableConfig
        from .program import default_main_program
        prog = program or default_main_program()
        if prog._optimizer is None:
            raise RuntimeError(
                "transpile() needs a program with an attached optimizer "
                "(call opt.minimize(loss) first; the reference requires the "
                "optimize ops before transpilation too)")
        rule, hyper = _server_rule(prog._optimizer)
        endpoints = [e.strip() for e in pservers.split(",") if e.strip()]
        if not endpoints:
            raise ValueError("pservers must name at least one endpoint")
        ctx = _PsTrainerCtx(prog, trainer_id, endpoints, trainers, sync_mode)
        self._tables = [
            TableConfig(tid, "dense", 0, rule, **hyper)
            for tid, _s in enumerate(ctx.train_slots)]
        prog._ps_ctx = ctx
        prog._optimizer = None  # the rule runs on the servers
        self._trainer_prog = prog
        self._endpoints = endpoints
        return self

    def get_trainer_program(self, wait_port=True):
        return self._trainer_prog

    def get_pserver_program(self, endpoint):
        return PsServerProgram(endpoint, self._tables)

    def get_pserver_programs(self, endpoint):
        ps = self.get_pserver_program(endpoint)
        return ps, self.get_startup_program(endpoint, ps)

    def get_startup_program(self, endpoint=None, pserver_program=None):
        from .program import Program
        return Program()  # parameters arrive with the first pull
