"""The meta-optimizers (counterpart:
``paddle_tpu/distributed/fleet/meta_optimizers``): each is a wrapper over
the optimizer object (DGC, LARS and LAMB rebuild it as their own class),
nested in ``StrategyCompiler.ORDER``, which ``fleet.distributed_optimizer``
resolves from a ``DistributedStrategy``.

Every wrapper keeps its state in device tensors updated in place and
gates with ``torch.where`` on device flags, so the whole stack runs inside
a captured k-step program (``jit.to_static``) on the card.
"""
from .amp import AMPOptimizer  # noqa: F401
from .asp import ASPOptimizer  # noqa: F401
from .dgc import DGCMomentumOptimizer  # noqa: F401
from .fp16_allreduce import FP16AllReduceOptimizer  # noqa: F401
from .gradient_merge import GradientMergeOptimizer  # noqa: F401
from .localsgd import LocalSGDOptimizer  # noqa: F401
from .recompute import RecomputeOptimizer, apply_recompute  # noqa: F401
from .sharding import (DygraphShardingOptimizer,  # noqa: F401
                       shard_optimizer_state)
from .strategy_compiler import StrategyCompiler  # noqa: F401

__all__ = ["AMPOptimizer", "ASPOptimizer", "DGCMomentumOptimizer",
           "FP16AllReduceOptimizer", "GradientMergeOptimizer",
           "LocalSGDOptimizer", "RecomputeOptimizer", "apply_recompute",
           "DygraphShardingOptimizer", "shard_optimizer_state",
           "StrategyCompiler"]
