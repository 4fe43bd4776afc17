"""Optimizer-state sharding (counterpart: ``meta_optimizers/sharding.py``).

Two mechanisms, picked per optimizer:

1. ZeRO's flat stores (``Optimizer._zero_enable`` at ``sharding_configs``'
   ``stage`` and ``comm_buffer_size_MB``): the elementwise optimizers.
2. Owners per parameter (``shard_optimizer_state``), for the optimizers
   that cannot run on flat rows (``Lamb``, ``Lars``, ``Dpsgd``, DGC) or a
   per-parameter rate or regularizer. The reference annotates each
   accumulator with a PartitionSpec and lets GSPMD hold 1/N of it; the
   port has no GSPMD and does what upstream Paddle's ``sharding/shard.py``
   does: each parameter's whole state goes to one rank of the axis, the
   parameters taken in order and each given to the rank holding the
   fewest elements so far. Every rank averages the gradients over the
   axis and clips them whole; the owner updates its parameters and
   broadcasts them. The result equals the replicated step (ROADMAP §3,
   deliberate differences).
"""
import warnings

import torch

from ... import collective, parallel_env
from ...parallel import fused_allreduce_grads
from ..base import topology as topo_mod
from ..meta_parallel.sharding_parallel import sharding_axis
from ._wrapper import MetaOptimizer


def _group_ranks(group):
    """Global ranks of ``group`` in group order."""
    ranks = getattr(group, "ranks", None)
    if ranks is not None:
        return list(ranks)
    import torch.distributed as dist
    return list(range(dist.get_world_size())) if collective._world() \
        else [0]


def shard_optimizer_state(optimizer, mesh=None, axis=topo_mod.AXIS_SHARD):
    """Give each trainable parameter's optimizer state to one rank of
    ``axis`` (greedily by size); the other ranks drop it. Returns the
    number of accumulators the owners keep."""
    if getattr(optimizer, "_fuse_acc", False):
        raise NotImplementedError(
            "optimizer-state sharding places per-parameter accumulators; "
            "fuse_accumulators=True optimizers shard through the ZeRO flat "
            "path (Optimizer._zero_enable / DygraphShardingOptimizer)")
    if mesh is None:
        hcg = topo_mod.get_hybrid_communicate_group()
        mesh = hcg.mesh if hcg is not None else None
    if mesh is not None and axis in mesh.shape:
        group = parallel_env.axis_group(mesh, axis)
        degree = parallel_env.axis_degree(mesh, axis)
        me = parallel_env.axis_rank(mesh, axis)
    else:
        group, degree, me = None, 1, 0
    load = [0] * degree
    owners = {}
    for p in optimizer._parameters():
        if not p.requires_grad:
            continue
        r = min(range(degree), key=lambda i: load[i])
        owners[id(p)] = r
        load[r] += p.numel()
    kept = 0
    for key in list(optimizer._accumulators):
        owner = owners.get(key[1])
        if owner is None:
            continue
        if owner == me:
            kept += 1
        else:
            del optimizer._accumulators[key]
    optimizer._owners = {"group": group, "rank": me, "owners": owners,
                         "ranks": _group_ranks(group)}
    return kept


class DygraphShardingOptimizer(MetaOptimizer):
    """The inner optimizer with its state sharded over the sharding axis
    (the data axis where the sharding degree is 1): ZeRO's flat path where
    it runs, else owners per parameter (module docstring), with a
    warning naming why."""

    def __init__(self, inner_optimizer, hcg=None, axis=None, strategy=None,
                 stage=None, comm_buffer_mb=None):
        super().__init__(inner_optimizer)
        hcg = hcg or topo_mod.get_hybrid_communicate_group()
        self._axis = axis or sharding_axis(hcg)
        cfg = {}
        if strategy is not None:
            cfg = getattr(strategy, "sharding_configs", None) or {}
        if stage is None:
            stage = int(cfg.get("stage", 1))
        if comm_buffer_mb is None:
            comm_buffer_mb = cfg.get("comm_buffer_size_MB",
                                     cfg.get("segment_broadcast_MB", 25.0))
        self._stage = int(stage)
        self._mesh = hcg.mesh if hcg is not None else None
        self._zero_flat = False
        try:
            self._n_sharded = inner_optimizer._zero_enable(
                axis=self._axis, mesh=self._mesh, stage=self._stage,
                comm_buffer_mb=float(comm_buffer_mb))
            self._zero_flat = True
        except NotImplementedError as e:
            warnings.warn(
                f"ZeRO flat sharding unavailable for "
                f"{type(inner_optimizer).__name__} ({e}); each parameter's "
                "state goes to one owner rank instead")
            self._n_sharded = shard_optimizer_state(
                inner_optimizer, mesh=self._mesh, axis=self._axis)

    def step(self):
        if self._zero_flat:
            return self._inner.step()
        if parallel_env.current_dp_axis() is not None:
            raise NotImplementedError(
                "the owner-per-parameter sharding steps outside a "
                "to_static(..., dp_axis=) program (its gradients are "
                "averaged here, and the program's optimizer would reduce "
                "them again)")
        own = self._inner._owners
        if own["group"] is not None and collective._world():
            fused_allreduce_grads(self._inner._parameters(),
                                  group=own["group"])
        self._inner.step()
        if own["group"] is None or not collective._world():
            return
        with torch.no_grad():
            for p in self._inner._parameters():
                owner = own["owners"].get(id(p))
                if owner is not None:
                    collective.broadcast(p.data, src=own["ranks"][owner],
                                         group=own["group"])
