"""LocalSGD (counterpart: ``meta_optimizers/localsgd.py``): every
``k_steps`` steps (from ``begin_step`` on) the parameters are averaged
over the data-parallel group.

Eagerly the step count is read on the host and the all-reduce runs on the
boundary only, as in the reference (the communication LocalSGD exists to
save). Inside a captured program the count stays on the device: every
step all-reduces every parameter and a ``torch.where`` on the boundary
flag applies the average. Where ``HybridParallelOptimizer`` has already
averaged the gradients, the ranks' parameters agree and the average
changes nothing (the reference's GSPMD data parallelism, likewise)."""
import torch

from ....optimizer.optimizer import _capturing
from ... import collective
from ._wrapper import MetaOptimizer


class LocalSGDOptimizer(MetaOptimizer):
    def __init__(self, inner_optimizer, k_steps=1, group=None,
                 begin_step=1):
        super().__init__(inner_optimizer)
        self._k = int(k_steps)
        self._group = group
        self._begin = begin_step
        dev = inner_optimizer._step_count.device
        self._local_step = torch.zeros((), dtype=torch.int32, device=dev)

    def step(self):
        self._inner.step()
        self._local_step.add_(1)
        if _capturing(self._local_step):
            trigger = (((self._local_step % self._k) == 0)
                       & (self._local_step >= self._begin))
            self._average_parameters(trigger)
        else:
            s = int(self._local_step)
            if s >= self._begin and s % self._k == 0:
                self._average_parameters(None)

    @torch.no_grad()
    def _average_parameters(self, trigger):
        for p in self._inner._parameters():
            t = p.detach().clone()
            collective.all_reduce(t, op=collective.ReduceOp.AVG,
                                  group=self._group)
            p.copy_(t if trigger is None else torch.where(trigger, t, p))
