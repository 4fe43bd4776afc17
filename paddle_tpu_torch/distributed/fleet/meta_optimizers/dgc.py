"""Deep Gradient Compression (counterpart: ``meta_optimizers/dgc.py``):
the DGC update rule on a ``Momentum`` (local momentum correction, top-k
selection by magnitude, error feedback); the transport stays dense, as in
the reference.

The threshold is the k-th largest ``|v|`` of each parameter (``torch.topk``,
exact), ``k = max(1, round(n * (1 - sparsity)))``, and the mask is ``>=``,
so ties pass as with ``jax.lax.top_k``. Until ``@step`` passes
``rampup_begin_step`` the update is plain momentum, selected on the device
by ``torch.where``; ``rampup_step`` is taken and unused, as in the
reference. The selection needs each whole parameter, so no ZeRO."""
import torch

from ....optimizer.optimizer import Momentum


class DGCMomentumOptimizer(Momentum):
    _zero_compatible = False
    _SLOTS = ("velocity", "dgc_u", "dgc_v")

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 parameters=None, use_nesterov=False, weight_decay=None,
                 grad_clip=None, name=None):
        self._rampup_begin = int(rampup_begin_step)
        self._sparsity = float(sparsity[-1] if isinstance(
            sparsity, (list, tuple)) else sparsity)
        super().__init__(learning_rate, momentum, parameters, use_nesterov,
                         weight_decay, grad_clip)

    def _k_of(self, n):
        return max(1, int(round(n * (1.0 - self._sparsity))))

    def _apply_one(self, p, value, g):
        g = self._decayed_grad(value, g, p)
        beta, lr = self._momentum, self._lr_t
        u, v, vel = (self._get_accumulator(s, p)
                     for s in ("dgc_u", "dgc_v", "velocity"))
        # the DGC branch: momentum correction, top-k, error feedback
        new_u = beta * u + g
        new_v = v + new_u
        mag = new_v.abs()
        flat = mag.reshape(-1)
        thr = torch.topk(flat, self._k_of(flat.numel())).values[-1]
        mask = mag >= thr
        comm = torch.where(mask, new_v, 0.0)
        res_v = torch.where(mask, 0.0, new_v)
        res_u = torch.where(mask, 0.0, new_u)  # momentum factor masking
        dgc_value = value - lr * comm
        # plain momentum during the rampup
        mom_v = beta * vel + g
        mom_value = (value - lr * (g + beta * mom_v) if self._nesterov
                     else value - lr * mom_v)
        in_rampup = self._step_count <= self._rampup_begin
        u.copy_(torch.where(in_rampup, u, res_u))
        v.copy_(torch.where(in_rampup, v, res_v))
        vel.copy_(torch.where(in_rampup, mom_v, vel))
        value.copy_(torch.where(in_rampup, mom_value, dgc_value))
