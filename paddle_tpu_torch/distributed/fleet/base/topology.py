"""Hybrid topology (counterpart:
``paddle_tpu/distributed/fleet/base/topology.py``).

``CommunicateTopology`` is the rank grid over the axes (data, pipe,
sharding, model), in that order with the last axis the fastest, as in the
reference. ``HybridCommunicateGroup`` builds the matching mesh over the
default process group (``parallel_env.make_mesh({"dp", "pp", "sharding",
"mp"})``: one ``new_group`` for every slice of every axis, degree 1 too) and
hands out this rank's coordinates and its :class:`collective.Group` on each
axis. Without an initialized process group of the topology's size it is
topology only: the coordinates of ``rank`` and the groups' rank lists, no
process groups.
"""
import numpy as np
import torch.distributed as dist

from ... import parallel_env
from ...collective import Group

# the mesh axes, in the reference's data x pipe x sharding x model order
AXIS_DATA = "dp"
AXIS_PIPE = "pp"
AXIS_SHARD = "sharding"
AXIS_MODEL = "mp"
HYBRID_AXES = [AXIS_DATA, AXIS_PIPE, AXIS_SHARD, AXIS_MODEL]
_TOPO_NAMES = ("data", "pipe", "sharding", "model")


class CommunicateTopology:
    def __init__(self, hybrid_group_names=_TOPO_NAMES, dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = None
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coord = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coord, self._dims))

    def get_coord(self, rank):
        return dict(zip(self._parallel_names,
                        (int(c) for c in np.unravel_index(rank, self._dims))))

    def get_comm_list(self, axis_name):
        """The rank lists of the groups along ``axis_name``: one per
        combination of the other axes' coordinates, in C order."""
        i = self._parallel_names.index(axis_name)
        grid = np.arange(self._world).reshape(self._dims)
        return [[int(r) for r in line] for line in
                np.moveaxis(grid, i, -1).reshape(-1, self._dims[i])]


class HybridCommunicateGroup:
    """This rank's place in the hybrid mesh: degrees, coordinates and the
    process group of each axis (``get_*_parallel_{group,rank,world_size}``).
    ``rank`` defaults to this process's rank (0 without a process
    group)."""

    def __init__(self, topology=None, strategy=None, rank=None):
        if topology is None:
            cfg = strategy.hybrid_configs if strategy else {}
            dims = (cfg.get("dp_degree", 1), cfg.get("pp_degree", 1),
                    cfg.get("sharding_degree", 1), cfg.get("mp_degree", 1))
            topology = CommunicateTopology(dims=dims)
        self._topo = topology
        names = topology.get_hybrid_group_names()
        self._axes = dict(zip(names, HYBRID_AXES))
        dims = {a: topology.get_dim(n) for n, a in self._axes.items()}
        self._dp_degree, self._pp_degree = dims[AXIS_DATA], dims[AXIS_PIPE]
        self._sharding_degree = dims[AXIS_SHARD]
        self._mp_degree = dims[AXIS_MODEL]
        live = (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() == topology.world_size())
        if rank is None:
            rank = dist.get_rank() if live else 0
        self.global_rank = int(rank)
        coord = topology.get_coord(self.global_rank)
        self._coord = {a: coord[n] for n, a in self._axes.items()}
        self.mesh = parallel_env.make_mesh(dims) if live else None
        self._groups = {}
        for gid, (name, axis) in enumerate(self._axes.items(), start=1):
            ranks = next(line for line in topology.get_comm_list(name)
                         if self.global_rank in line)
            pg = self.mesh.groups[axis] if self.mesh is not None else None
            self._groups[axis] = Group(pg, ranks, axis_name=axis, gid=gid,
                                       global_rank=self.global_rank)

    # -- degrees, ranks and groups ----------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_data_parallel_rank(self):
        return self._coord[AXIS_DATA]

    def get_model_parallel_rank(self):
        return self._coord[AXIS_MODEL]

    def get_stage_id(self):
        return self._coord[AXIS_PIPE]

    def get_sharding_parallel_rank(self):
        return self._coord[AXIS_SHARD]

    def get_data_parallel_group(self):
        return self._groups[AXIS_DATA]

    def get_model_parallel_group(self):
        return self._groups[AXIS_MODEL]

    def get_pipe_parallel_group(self):
        return self._groups[AXIS_PIPE]

    def get_sharding_parallel_group(self):
        return self._groups[AXIS_SHARD]

    def get_check_parallel_group(self):
        return Group(None, range(self._topo.world_size()), gid=5,
                     global_rank=self.global_rank)

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_group_src_rank(self):
        return self._groups[AXIS_DATA].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups[AXIS_MODEL].ranks[0]

    def topology(self):
        return self._topo

    def get_hybrid_group_names(self):
        return self._topo.get_hybrid_group_names()


_hcg = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group():
    return _hcg
