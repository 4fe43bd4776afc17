"""FP16 gradient all-reduce (counterpart:
``meta_optimizers/fp16_allreduce.py``): each floating gradient is
quantized through the communication dtype and back before the inner step,
the reference's semantics. The dp reduction has already run by then
(``HybridParallelOptimizer.step``, as GSPMD's has in the reference), so no
float16 goes over the wire (ROADMAP §3)."""
import torch

from ....core.dtype import convert_dtype
from ._wrapper import MetaOptimizer


class FP16AllReduceOptimizer(MetaOptimizer):
    def __init__(self, inner_optimizer, dtype="float16"):
        super().__init__(inner_optimizer)
        self._comm_dtype = convert_dtype(dtype)

    @torch.no_grad()
    def _quantize_grads(self):
        for p in self._inner._parameters():
            g = p.grad
            if g is not None and g.is_floating_point() and not g.is_sparse:
                g.copy_(g.to(self._comm_dtype).to(g.dtype))

    def step(self):
        self._quantize_grads()
        self._inner.step()
