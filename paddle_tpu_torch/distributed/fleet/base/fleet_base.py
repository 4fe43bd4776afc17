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
``distributed_optimizer`` returns a ``HybridParallelOptimizer``: with
``strategy.sharding`` the inner optimizer's state goes to ZeRO over the dp
axis (the sharding axis where its degree is above one) at
``sharding_configs["stage"]``; otherwise its ``step`` first averages the
gradients over the dp group (outside a ``to_static(..., dp_axis=)``
program, whose optimizer reduces by itself). A global-norm clip sums the
squares of sliced parameters over the mp group and of each stage's over
the pipe group, where those degrees are above one.

The parameter-server half (``init_server``, ``run_server``,
``init_worker``, ``ps_step``, ...) is not ported: each raises by name.
"""
from ... import collective, parallel_env
from ...parallel import DataParallel, fused_allreduce_grads
from ....nn.clip import ClipGradByGlobalNorm
from .distributed_strategy import DistributedStrategy
from .topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

_strategy = None

# meta-optimizer switches of the strategy that the port does not run
_UNPORTED = ("amp", "dgc", "localsgd", "adaptive_localsgd", "lamb", "lars",
             "fp16_allreduce", "asp", "gradient_merge", "a_sync")


def init(role_maker=None, is_collective=True, strategy=None, device=None):
    """Build the hybrid mesh of ``strategy.hybrid_configs`` over the
    default process group (created here if there is none, on ``device``:
    the card unless ``"cpu"``); returns the ``HybridCommunicateGroup``."""
    global _strategy
    if not is_collective or not getattr(role_maker, "_is_collective", True):
        raise NotImplementedError("fleet.init for the parameter server is "
                                  "not ported")
    _strategy = strategy or DistributedStrategy()
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
    return parallel_env.get_rank()


def worker_num():
    return parallel_env.get_world_size()


def is_first_worker():
    return worker_index() == 0


def is_server():
    return False


def is_worker():
    return True


def barrier_worker():
    collective.barrier()


def _ps_only(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"fleet.{name} (the parameter server) is "
                                  "not ported")
    fn.__name__ = name
    return fn


init_server = _ps_only("init_server")
run_server = _ps_only("run_server")
init_worker = _ps_only("init_worker")
ps_step = _ps_only("ps_step")
ps_runtime = _ps_only("ps_runtime")
save_persistables = _ps_only("save_persistables")
shutdown_servers = _ps_only("shutdown_servers")
stop_worker = _ps_only("stop_worker")


def _hcg():
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init first")
    return hcg


def _apply_recompute(model, checkpoints):
    """Recompute (``full``) the sublayers whose structured name matches a
    pattern of ``checkpoints`` (fnmatch or substring)."""
    import fnmatch
    wrapped = []
    for name, sub in model.named_sublayers():
        if any(fnmatch.fnmatch(name, p) or p in name for p in checkpoints):
            sub.enable_recompute("full")
            wrapped.append(name)
    return wrapped


def distributed_model(model):
    """Wrap ``model`` by the active degrees (see the module docstring)."""
    from ..meta_parallel import (PipelineLayer, PipelineParallel,
                                 ShardingParallel, TensorParallel)
    hcg = _hcg()
    if _strategy is not None and _strategy.recompute:
        _apply_recompute(model, _strategy.recompute_configs.get(
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
    global _strategy
    strategy = strategy or _strategy or DistributedStrategy()
    on = [k for k in _UNPORTED if getattr(strategy, k, False)]
    if on:
        raise NotImplementedError(f"strategy switches {on} (meta-optimizers) "
                                  "are not ported")
    return HybridParallelOptimizer(optimizer, _hcg(), strategy)


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

    def __init__(self, optimizer, hcg, strategy):
        from ..meta_parallel.sharding_parallel import sharding_axis
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        clip = optimizer._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm) and (
                hcg.get_model_parallel_world_size() > 1
                or hcg.get_pipe_parallel_world_size() > 1):
            optimizer._grad_clip = HybridParallelClipGrad(clip.clip_norm, hcg)
        self._sharded = bool(strategy.sharding
                             or hcg.get_sharding_parallel_world_size() > 1)
        if self._sharded:
            cfg = strategy.sharding_configs or {}
            optimizer._zero_enable(
                axis=sharding_axis(hcg), mesh=hcg.mesh,
                stage=int(cfg.get("stage", 1)),
                comm_buffer_mb=float(cfg.get("comm_buffer_size_MB", 25.0)))

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
