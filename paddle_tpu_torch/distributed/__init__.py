"""Data parallelism over ``torch.distributed`` (counterpart:
``paddle_tpu/distributed``): the mesh and process environment
(``parallel_env``), the collectives (``collective``) and the gradient
buckets of the ZeRO step (``bucketing``)."""
from . import bucketing, collective, parallel_env  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         barrier, broadcast, reduce, reduce_scatter)
from .parallel_env import (Mesh, ParallelEnv, current_mesh,  # noqa: F401
                           get_rank, get_world_size, init_parallel_env,
                           make_mesh, set_mesh)

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce",
           "reduce_scatter", "broadcast", "barrier", "get_rank",
           "get_world_size", "init_parallel_env", "make_mesh", "set_mesh",
           "current_mesh", "Mesh", "ParallelEnv", "bucketing", "collective",
           "parallel_env"]
