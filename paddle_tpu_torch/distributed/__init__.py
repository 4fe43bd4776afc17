"""Distributed training over ``torch.distributed`` (counterpart:
``paddle_tpu/distributed``): the mesh and process environment
(``parallel_env``: one dp axis, or the hybrid dp x pp x sharding x mp
axes), the collectives (``collective``), the gradient buckets of the ZeRO
step (``bucketing``), ``DataParallel`` and the fleet facade with its
tensor-parallel and pipeline layers (``fleet``), and the runtime
services: ``spawn``, the trainer launcher (``launch``), the pod runtime
with its supervisor (``pod``) and the shared ``RestartPolicy``
(``restart``)."""
from . import bucketing, collective, parallel_env  # noqa: F401
from . import launch, pod, restart  # noqa: F401
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         alltoall, barrier, broadcast, new_group, recv,
                         reduce, reduce_scatter, scatter, send, split,
                         wait)
from .parallel import DataParallel  # noqa: F401
from .parallel_env import (Mesh, ParallelEnv, current_mesh,  # noqa: F401
                           get_rank, get_world_size, init_parallel_env,
                           make_mesh, set_mesh)
from .pod import (BarrierTimeoutError, PodCoordinator,  # noqa: F401
                  PodError, PodRuntime, RankFailedError,
                  StaleGenerationError, start_coordinator)
from .spawn import spawn  # noqa: F401
from . import fleet  # noqa: F401,E402

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce",
           "reduce_scatter", "broadcast", "barrier", "alltoall", "send",
           "recv", "scatter", "new_group", "wait", "split", "get_rank",
           "get_world_size", "init_parallel_env", "make_mesh", "set_mesh",
           "current_mesh", "Mesh", "ParallelEnv", "DataParallel",
           "bucketing", "collective", "parallel_env", "fleet", "spawn",
           "launch", "pod", "restart", "PodRuntime", "PodCoordinator",
           "start_coordinator", "PodError", "RankFailedError",
           "BarrierTimeoutError", "StaleGenerationError"]
