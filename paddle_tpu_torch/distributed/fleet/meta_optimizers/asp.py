"""The ASP meta-optimizer (counterpart: ``meta_optimizers/asp.py``): the
2:4 masks re-applied on the device after every inner step, to the
parameters and to the inner optimizer's float32 masters (which the
reference leaves, so its masters bring the pruned weights back: ROADMAP
§3)."""
from ....sparsity import ASPHelper
from ._wrapper import MetaOptimizer


class ASPOptimizer(MetaOptimizer):
    def step(self):
        self._inner.step()
        ASPHelper._reapply(list(self._inner._parameters()), self._inner)
