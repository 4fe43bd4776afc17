"""ShardingParallel (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/sharding_parallel.py``).

ZeRO is the optimizer's layout here (``Optimizer._zero_enable``, reached
through ``fleet.distributed_optimizer`` with ``strategy.sharding``): its
stores shard and reduce over one mesh axis, the ``sharding`` axis where
its degree is above one, else ``dp``, and only that axis's group, whatever
other axes the mesh has. The wrapper broadcasts the parameters over that
group at wrap time and names the axis for
``jit.to_static(..., dp_axis=model.dp_axis)``.
"""
from ... import collective
from ...parallel import _LayerWrapper, broadcast_parameters
from ..base import topology as topo_mod


def sharding_axis(hcg):
    """The mesh axis ZeRO shards over under ``hcg``."""
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        return topo_mod.AXIS_SHARD
    return topo_mod.AXIS_DATA


class ShardingParallel(_LayerWrapper):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        self._hcg = hcg
        self._axis = sharding_axis(hcg)
        if collective._world() and hcg is not None:
            group = (hcg.get_sharding_parallel_group()
                     if self._axis == topo_mod.AXIS_SHARD
                     else hcg.get_data_parallel_group())
            broadcast_parameters(list(layers.parameters()), group)

    @property
    def dp_axis(self):
        """The axis for ``to_static(..., dp_axis=model.dp_axis)``."""
        return self._axis

    def scale_loss(self, loss):
        return loss
