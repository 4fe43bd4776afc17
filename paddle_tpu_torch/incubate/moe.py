"""MoELayer (counterpart: ``paddle_tpu/incubate/moe.py``): a Switch FFN
over ``parallel.moe.moe_ffn``.

The initial weights are the reference's draws: a numpy ``RandomState``
seeded from the layer's ``name`` (crc32; 0 without one), uniform in
``±1/sqrt(d_model)`` for the gate and the expert matrices, zeros for the
biases, so a named layer starts alike in both packages and on every rank.
``shard_experts(group)`` keeps this rank's ``num_experts / ep`` experts
and routes over the group. The load-balance loss of the last forward is
``aux_loss`` (add it to the training loss).
"""
import zlib

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn.layer.layers import Layer
from ..parallel.moe import _gelu, moe_ffn


class MoELayer(Layer):
    def __init__(self, d_model, d_hidden, num_experts, capacity_factor=1.25,
                 activation=_gelu, name=None, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self._act = activation
        self._group = None
        dev = resolve_device(device)
        k = 1.0 / np.sqrt(d_model)
        rng = np.random.RandomState(
            zlib.crc32(name.encode()) % (2 ** 31) if name else 0)

        def param(shape, uniform=True):
            v = rng.uniform(-k, k, shape) if uniform else np.zeros(shape)
            return torch.nn.Parameter(torch.tensor(v, dtype=torch.float32,
                                                   device=dev))

        self.gate_weight = param([d_model, num_experts])
        self.w1 = param([num_experts, d_model, d_hidden])
        self.b1 = param([num_experts, d_hidden], uniform=False)
        self.w2 = param([num_experts, d_hidden, d_model])
        self.b2 = param([num_experts, d_model], uniform=False)
        self.register_buffer("aux_loss", torch.zeros((), device=dev),
                             persistent=False)

    def shard_experts(self, group):
        """Keep this rank's experts of ``group`` (the ep group) and route
        over it."""
        from ..distributed.fleet.meta_parallel.mp_layers import \
            group_rank_size
        rank, ep = group_rank_size(group)
        if self.num_experts % ep:
            raise ValueError(f"{self.num_experts} experts do not divide "
                             f"over ep={ep}")
        per = self.num_experts // ep
        with torch.no_grad():
            for name in ("w1", "b1", "w2", "b2"):
                full = getattr(self, name)
                setattr(self, name, torch.nn.Parameter(
                    full[rank * per:(rank + 1) * per].clone()))
        self._group = group
        return self

    def forward(self, x):
        shape = x.shape
        y, aux = moe_ffn(x.reshape(-1, shape[-1]), self.gate_weight,
                         self.w1, self.b1, self.w2, self.b2,
                         group=self._group,
                         capacity_factor=self.capacity_factor,
                         activation=self._act)
        self.aux_loss = aux
        return y.reshape(shape)
