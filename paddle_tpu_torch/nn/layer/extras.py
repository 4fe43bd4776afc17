"""The layer tail (counterpart: ``paddle_tpu/nn/layer/extras.py``): the
generic ``RNN`` and ``BiRNN`` over any cell, ``SpectralNorm``, and the
layer fronts of ``unfold``, ``alpha_dropout``, ``interpolate``,
``ctc_loss``, ``cosine_embedding_loss`` and ``triplet_margin_loss``.

``SpectralNorm``'s ``u`` and ``v`` start from ``np.random.RandomState(0)``
as the reference's do, so they are the reference's bit for bit; each
forward runs the power iteration without gradient, writes them in place
and divides the weight by ``u . (W v)``.
"""
import numpy as np
import torch
from torch.utils import _pytree as pytree

from ...core import dispatch as _dispatch
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["RNN", "BiRNN", "SpectralNorm", "Unfold", "AlphaDropout",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "CTCLoss",
           "CosineEmbeddingLoss", "TripletMarginLoss"]


class RNN(Layer):
    """Runs ``cell(x_t, states) -> (out, states)`` over time. With
    ``sequence_length``, each sample's states freeze and its outputs are
    zero past its length (in reverse, its padding comes first and leaves
    the states as given)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        steps = (range(x.shape[0] - 1, -1, -1) if self.is_reverse
                 else range(x.shape[0]))
        seq_len = (None if sequence_length is None
                   else sequence_length.to(torch.int32))
        states = initial_states
        outs = []
        for t in steps:
            out, new_states = self.cell(x[t], states)
            if seq_len is not None:
                valid = (t < seq_len).unsqueeze(-1)
                out = out * valid.to(out.dtype)
                old = (states if states is not None
                       else pytree.tree_map(lambda n: n * 0.0, new_states))
                new_states = pytree.tree_map(
                    lambda n, o: n * valid.to(n.dtype)
                    + o * (1.0 - valid.to(o.dtype)), new_states, old)
            states = new_states
            outs.append(out)
        if self.is_reverse:
            outs.reverse()
        y = torch.stack(outs)
        if not self.time_major:
            y = y.transpose(0, 1)
        return y, states


class BiRNN(Layer):
    """A forward and a reversed ``RNN``, their outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        y_fw, st_fw = self.rnn_fw(inputs, s_fw, sequence_length)
        y_bw, st_bw = self.rnn_bw(inputs, s_bw, sequence_length)
        return torch.cat([y_fw, y_bw], dim=-1), (st_fw, st_bw)


class SpectralNorm(Layer):
    """``W / sigma_max(W)`` with ``sigma`` from ``power_iters`` steps of
    power iteration on the persistent ``weight_u`` ``[W.shape[dim]]`` and
    ``weight_v`` ``[prod of the other dims]`` (parameters that take no
    gradient)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", device=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = int(weight_shape[dim])
        w = int(np.prod([s for i, s in enumerate(weight_shape) if i != dim]))
        rng = np.random.RandomState(0)
        for name, n in (("weight_u", h), ("weight_v", w)):
            setattr(self, name, self.create_parameter(
                [n], dtype=dtype, device=device,
                attr=I.Assign(rng.randn(n))))
            getattr(self, name).requires_grad_(False)

    def forward(self, weight):
        dim = self._dim
        m = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
        with torch.no_grad():
            md = m.detach()
            u, v = self.weight_u.detach(), self.weight_v.detach()
            for _ in range(self._power_iters):
                v = md.T @ u
                v = v / (torch.linalg.vector_norm(v) + self._eps)
                u = md @ v
                u = u / (torch.linalg.vector_norm(u) + self._eps)
            if _dispatch.recorder() is None:
                # a Program records the power step as ops of its own and,
                # as the reference's recorder, writes no vector back
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = u @ (m @ v)
        return weight / sigma


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self._args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        k, s, p, d = self._args
        return F.unfold(x, kernel_sizes=k, strides=s, paddings=p,
                        dilations=d)


class AlphaDropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class UpsamplingBilinear2D(Layer):
    """Bilinear with ``align_corners=True``."""

    def __init__(self, size=None, scale_factor=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor,
                             mode="bilinear", align_corners=True)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode="nearest")


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label,
                                       margin=self.margin,
                                       reduction=self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, reduction="mean"):
        super().__init__()
        self._kw = dict(margin=margin, p=p, epsilon=epsilon,
                        reduction=reduction)

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, **self._kw)
