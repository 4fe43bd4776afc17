"""Fleet (counterpart: ``paddle_tpu/distributed/fleet``): the collective
facade (``init``, ``distributed_model``, ``distributed_optimizer``, the
hybrid topology), the meta-parallel layers and wrappers
(``meta_parallel``), and the filesystem abstraction the checkpoint core
writes through (``utils.fs.LocalFS``) and the elastic manager
(``elastic``), the role makers, the datasets and the parameter-server
entry points (``distributed.ps``)."""
from . import elastic, meta_parallel, utils  # noqa: F401
from .base import fleet_base as _fb
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.role_maker import (PaddleCloudRoleMaker,  # noqa: F401
                              UserDefinedRoleMaker)
from .dataset import InMemoryDataset, QueueDataset  # noqa: F401
from .base.topology import (CommunicateTopology,  # noqa: F401
                            HybridCommunicateGroup)
from .elastic import ElasticManager  # noqa: F401

init = _fb.init
distributed_model = _fb.distributed_model
distributed_optimizer = _fb.distributed_optimizer
get_hybrid_communicate_group = _fb.get_hybrid_communicate_group
worker_index = _fb.worker_index
worker_num = _fb.worker_num
is_first_worker = _fb.is_first_worker
is_server = _fb.is_server
is_worker = _fb.is_worker
barrier_worker = _fb.barrier_worker
stop_worker = _fb.stop_worker
init_server = _fb.init_server
run_server = _fb.run_server
init_worker = _fb.init_worker
ps_step = _fb.ps_step
ps_runtime = _fb.ps_runtime
save_persistables = _fb.save_persistables
shutdown_servers = _fb.shutdown_servers

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "InMemoryDataset",
           "QueueDataset",
           "HybridCommunicateGroup", "meta_parallel", "utils", "elastic",
           "ElasticManager", "init",
           "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group", "worker_index", "worker_num",
           "is_first_worker", "is_server", "is_worker", "barrier_worker",
           "stop_worker", "init_server", "run_server", "init_worker",
           "ps_step", "ps_runtime", "save_persistables", "shutdown_servers"]
