"""linear, embedding, dropout (counterpart:
``paddle_tpu/nn/functional/common.py``). Plain torch ops: the JAX package
left these to XLA. ``linear`` and ``embedding`` consult ``amp.auto_cast``."""
import torch

from ...amp.auto_cast import cast_inputs
from ...core.random import default_generator


def linear(x, weight, bias=None):
    """y = x @ W + b with the reference's weight layout W: [in, out]."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None):
    """Row lookup; rows whose id is ``padding_idx`` come out as zeros."""
    (weight,) = cast_inputs("embedding", weight)
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Reference dropout semantics (identity in eval mode or at p = 0);
    the keep mask draws from the package's seeded generator for ``x``'s
    device."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    u = torch.rand(shape, generator=default_generator(x.device),
                   device=x.device)
    keep = u >= p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)
