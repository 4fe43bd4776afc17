"""Gradient merge (counterpart: ``meta_optimizers/gradient_merge.py``):
``k_steps`` micro-steps' gradients summed into float32 buffers (averaged
with ``avg``) and applied once a window.

The inner step runs at every micro-step on the merged gradient; a
``torch.where`` on the device's boundary flag then keeps its result or
the state from before it, for every tensor the step writes (the
parameters, the accumulators or the fused or ZeRO stores that hold them,
the float32 masters and ``@step``: ``amp.grad_scaler``'s list). So the
window runs branch-free inside a captured k-step program."""
import torch

from ....amp.grad_scaler import _state_tensors
from ._wrapper import MetaOptimizer


class GradientMergeOptimizer(MetaOptimizer):
    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if getattr(inner_optimizer, "_fuse_acc", False):
            raise NotImplementedError(
                "GradientMergeOptimizer rolls the accumulator state back "
                "per parameter, as the reference's does; wrap an optimizer "
                "without fuse_accumulators=True")
        super().__init__(inner_optimizer)
        self._k = int(k_steps)
        self._avg = avg
        params = [p for p in inner_optimizer._parameters() if p.requires_grad]
        dev = params[0].device if params else torch.device("cpu")
        self._merge_step = torch.zeros((), dtype=torch.int32, device=dev)
        self._buffers = {id(p): torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                         for p in params}
        # the parameters that saw a gradient: from then on each micro-step
        # merges them (with zeros where a micro-step gives none), so their
        # buffer applies and resets at the window's boundary
        self._seen = set()

    @torch.no_grad()
    def step(self):
        self._merge_step.add_(1)
        boundary = (self._merge_step % self._k) == 0
        params = [p for p in self._inner._parameters()
                  if p.requires_grad
                  and (p.grad is not None or id(p) in self._seen)]
        for p in params:
            self._seen.add(id(p))
            buf = self._buffers[id(p)]
            acc = buf if p.grad is None else buf + p.grad.float()
            merged = acc / self._k if self._avg else acc
            p.grad = merged.to(p.dtype)
            buf.copy_(torch.where(boundary, 0.0, acc))
        state = _state_tensors(self._inner)
        old = [t.clone() for t in state]
        self._inner.step()
        for t, o in zip(state, old):
            t.copy_(torch.where(boundary, t, o))
        zero = self._inner._zero
        if zero is not None and zero.stage == 3:
            zero.refresh_parameters()  # gathered before the selection
        for p in params:
            p.grad = None  # merged into the buffer or taken by the update
