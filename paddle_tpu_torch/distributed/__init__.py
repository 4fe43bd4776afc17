"""Distributed training over ``torch.distributed`` (counterpart:
``paddle_tpu/distributed``): the mesh and process environment
(``parallel_env``: one dp axis, or the hybrid dp x pp x sharding x mp
axes), the collectives (``collective``), the gradient buckets of the ZeRO
step (``bucketing``), ``DataParallel`` and the fleet facade with its
tensor-parallel and pipeline layers (``fleet``)."""
from . import bucketing, collective, parallel_env  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         alltoall, barrier, broadcast, new_group, recv,
                         reduce, reduce_scatter, scatter, send, split,
                         wait)
from .parallel import DataParallel  # noqa: F401
from .parallel_env import (Mesh, ParallelEnv, current_mesh,  # noqa: F401
                           get_rank, get_world_size, init_parallel_env,
                           make_mesh, set_mesh)
from . import fleet  # noqa: F401,E402

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce",
           "reduce_scatter", "broadcast", "barrier", "alltoall", "send",
           "recv", "scatter", "new_group", "wait", "split", "get_rank",
           "get_world_size", "init_parallel_env", "make_mesh", "set_mesh",
           "current_mesh", "Mesh", "ParallelEnv", "DataParallel",
           "bucketing", "collective", "parallel_env", "fleet"]
