"""The fleet facade, its collective half (counterpart:
``paddle_tpu/distributed/fleet/base/fleet_base.py``).

The hybrid recipe::

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    strategy.sharding = True          # ZeRO over the dp axis
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(optimizer.AdamW(...))

``init`` creates the default process group where there is none (NCCL on
the card, gloo with ``device="cpu"``), builds the hybrid mesh over it
(``HybridCommunicateGroup``) and makes it the current mesh.
``distributed_model`` wraps by the degrees, as the reference does:
``PipelineParallel`` for a ``PipelineLayer`` at pp > 1, ``TensorParallel``
at mp > 1, ``ShardingParallel`` at sharding > 1, else ``DataParallel``.
``distributed_optimizer`` resolves the strategy's meta-optimizer stack
(``meta_optimizers.StrategyCompiler``: dgc, lars, lamb, sharding,
fp16_allreduce, gradient_merge, localsgd, asp, amp, innermost first),
applies it and returns a ``HybridParallelOptimizer`` over it that records
the stack's names (``_meta_optimizer_names``). With ``sharding`` in the
stack the state goes to ZeRO over the dp axis (the sharding axis where
its degree is above one) at ``sharding_configs["stage"]``, or to owners
per parameter for the optimizers that cannot run flat
(``meta_optimizers.sharding``); otherwise the ``step`` first averages the
gradients over the dp group (outside a ``to_static(..., dp_axis=)``
program, whose optimizer reduces by itself). A global-norm clip sums the
squares of sliced parameters over the mp group and of each stage's over
the pipe group, where those degrees are above one.

The parameter-server half: ``init`` with a non-collective role (or
``is_collective=False``) builds a ``distributed.ps.PsRuntime`` and no mesh;
``is_server``, ``init_server``, ``run_server``, ``init_worker``,
``ps_step``, ``ps_runtime``, ``barrier_worker``, ``save_persistables``,
``stop_worker`` and ``shutdown_servers`` then act on it, as the
reference's do. ``strategy.a_sync`` selects the PS mode (async, or geo with
``a_sync_configs["k_steps"]``) and, as in the reference, no meta-optimizer:
``distributed_optimizer`` passes it through.
"""
from ... import collective, parallel_env
from ...parallel import DataParallel, fused_allreduce_grads
from ....nn.clip import ClipGradByGlobalNorm
from .distributed_strategy import DistributedStrategy
from .topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

_strategy = None
_role_maker = None
_ps_runtime = None


def init(role_maker=None, is_collective=True, strategy=None, device=None):
    """Build the hybrid mesh of ``strategy.hybrid_configs`` over the
    default process group (created here if there is none, on ``device``:
    the card unless ``"cpu"``); returns the ``HybridCommunicateGroup``.
    With a non-collective role (``PaddleCloudRoleMaker(is_collective=
    False)``, or ``is_collective=False``) it builds the parameter-server
    runtime instead and returns it."""
    global _strategy, _role_maker, _ps_runtime
    from .role_maker import PaddleCloudRoleMaker
    _role_maker = role_maker or PaddleCloudRoleMaker(
        is_collective=is_collective)
    _strategy = strategy or DistributedStrategy()
    if not getattr(_role_maker, "_is_collective", is_collective):
        from ...ps import PsRuntime
        _ps_runtime = PsRuntime(_role_maker, _strategy)
        return _ps_runtime
    _ps_runtime = None  # a collective re-init drops a stale PS runtime
    parallel_env.init_parallel_env(device=device)
    hcg = HybridCommunicateGroup(strategy=_strategy)
    if hcg.mesh is None:
        dims = _strategy.hybrid_configs
        raise ValueError(f"hybrid_configs {dims} need a world of "
                         f"{hcg.topology().world_size()} ranks; this one has "
                         f"{parallel_env.get_world_size()}")
    set_hybrid_communicate_group(hcg)
    parallel_env.set_mesh(hcg.mesh)
    return hcg


def worker_index():
    if _ps_runtime is not None:
        return _role_maker.worker_index()
    return parallel_env.get_rank()


def worker_num():
    if _ps_runtime is not None:
        return _role_maker.worker_num()
    return parallel_env.get_world_size()


def is_first_worker():
    return worker_index() == 0


def is_server():
    return _role_maker is not None and _role_maker.is_server()


def is_worker():
    return _role_maker is None or _role_maker.is_worker()


def barrier_worker():
    """The workers' barrier: through server 0 in parameter-server mode,
    else the process group's."""
    if _ps_runtime is not None:
        if _ps_runtime.client is not None:
            _ps_runtime.client.barrier(_role_maker.worker_num(),
                                       timeout=600.0)
        return
    collective.barrier()


def _ps():
    if _ps_runtime is None:
        raise RuntimeError("call fleet.init with a parameter-server role "
                           "(is_collective=False) first")
    return _ps_runtime


# -- parameter-server entry points (reference: fleet_base.py init_server
# :1080 / run_server / init_worker / save_persistables over TheOnePSRuntime)
def init_server(model=None, port=None):
    """Start this process's PS server with the tables of the constructed
    ``SparseEmbedding`` layers and ``model``'s dense parameters."""
    return _ps().init_server(model=model, port=port)


def run_server():
    """Serve until a worker stops the servers (``shutdown_servers``)."""
    _ps().run_server()


def init_worker(model=None):
    """Connect this worker: client, communicator, bound embeddings, dense
    parameters aligned with the server's."""
    return _ps().init_worker(model=model)


def ps_step(optimizer=None):
    """Post-backward communicator step for PS workers."""
    _ps().step(optimizer)


def ps_runtime():
    return _ps_runtime


def save_persistables(executor=None, dirname=None, main_program=None):
    """Snapshot every server's tables to ``dirname``.<server index>."""
    if _ps_runtime is not None and dirname is not None:
        _ps_runtime.save_persistables(dirname)


def stop_worker():
    if _ps_runtime is not None:
        _ps_runtime.stop_worker()


def shutdown_servers():
    if _ps_runtime is not None:
        _ps_runtime.shutdown_servers()


def _hcg():
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init first")
    return hcg


def distributed_model(model):
    """Wrap ``model`` by the active degrees (see the module docstring)."""
    from ..meta_optimizers.recompute import apply_recompute
    from ..meta_parallel import (PipelineLayer, PipelineParallel,
                                 ShardingParallel, TensorParallel)
    hcg = _hcg()
    if _strategy is not None and _strategy.recompute:
        apply_recompute(model, _strategy.recompute_configs.get(
            "checkpoints", []))
    if hcg.get_pipe_parallel_world_size() > 1 and isinstance(model,
                                                            PipelineLayer):
        return PipelineParallel(model, hcg, _strategy)
    if hcg.get_model_parallel_world_size() > 1:
        return TensorParallel(model, hcg, _strategy)
    if hcg.get_sharding_parallel_world_size() > 1:
        return ShardingParallel(model, hcg, _strategy)
    return DataParallel(model)


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer under the hybrid mesh: the strategy's meta-optimizer
    stack over it, in a ``HybridParallelOptimizer`` that records the
    stack's names (``_meta_optimizer_names``); in parameter-server mode,
    where the servers apply the rule (the worker's optimizer steps only in
    geo mode, through ``ps_step``), the optimizer itself."""
    from ..meta_optimizers.strategy_compiler import StrategyCompiler
    global _strategy
    strategy = strategy or _strategy or DistributedStrategy()
    if _ps_runtime is not None:
        return optimizer
    hcg = _hcg()
    stack = StrategyCompiler().resolve(strategy, hcg, optimizer)
    wrapped = HybridParallelOptimizer(
        StrategyCompiler.apply(stack, optimizer), hcg, strategy,
        sharded="sharding" in dict(stack))
    wrapped._meta_optimizer_names = [name for name, _ in stack]
    return wrapped


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global norm over the whole hybrid model: the squares of sliced
    (``split_axis`` set) parameters summed over the mp group, then every
    stage's sum over the pipe group."""

    def __init__(self, clip_norm, hcg):
        super().__init__(clip_norm)
        self._hcg = hcg

    def _total_sq(self, params, sq):
        import torch
        from ..meta_parallel.mp_layers import is_sliced
        zero = sq.new_zeros(())
        sliced = [s for p, s in zip(params, sq.unbind())
                  if is_sliced(p)]
        whole = [s for p, s in zip(params, sq.unbind())
                 if not is_sliced(p)]
        part = torch.stack(sliced).sum() if sliced else zero.clone()
        if self._hcg.get_model_parallel_world_size() > 1:
            collective.all_reduce(part, group=self._hcg
                                  .get_model_parallel_group())
        total = part + (torch.stack(whole).sum() if whole else zero)
        if self._hcg.get_pipe_parallel_world_size() > 1:
            collective.all_reduce(total, group=self._hcg
                                  .get_pipe_parallel_group())
        return total


class HybridParallelOptimizer:
    """The optimizer under the hybrid mesh (see the module docstring);
    every other attribute is the inner optimizer's."""

    def __init__(self, optimizer, hcg, strategy, sharded=False):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._meta_optimizer_names = []
        base = optimizer
        while "_inner" in vars(base):  # under the meta-optimizers
            base = base._inner
        clip = base._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm) and (
                hcg.get_model_parallel_world_size() > 1
                or hcg.get_pipe_parallel_world_size() > 1):
            base._grad_clip = HybridParallelClipGrad(clip.clip_norm, hcg)
        # the sharding meta-optimizer reduces the gradients itself
        self._sharded = bool(sharded)

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def step(self):
        if (not self._sharded and collective._world()
                and parallel_env.current_dp_axis() is None):
            fused_allreduce_grads(
                self._inner_opt._parameters(),
                group=self._hcg.get_data_parallel_group())
        self._inner_opt.step()

    minimize_step = step

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)
