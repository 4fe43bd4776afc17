"""Meta-parallel wrappers and layers (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel``): tensor-parallel layers and
``TensorParallel``, ``PipelineLayer`` and ``PipelineParallel``,
``ShardingParallel`` and the tensor-parallel RNG tracker."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding)
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)
from .sharding_parallel import ShardingParallel  # noqa: F401
from .tensor_parallel import TensorParallel  # noqa: F401

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer", "PipelineParallel",
           "TensorParallel", "ShardingParallel", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed"]
