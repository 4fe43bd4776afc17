"""Gradient clipping (counterpart: ``paddle_tpu/nn/clip.py``).

Each clip maps a list of (param, grad) pairs to a new one before the
optimizer applies its update. Scaled gradients keep their dtype; the scale
is applied in float32.
"""
import torch


class ClipGradBase:
    def _clip(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


def _grad_scale(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to L2 norm at most ``clip_norm`` (the norm is
    taken in the gradient's dtype, as in the reference)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = g.square().sum().sqrt()
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-12),
                                max=1.0)
            out.append((p, _grad_scale(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled together so that their joint L2 norm, taken in
    float32, is at most ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        sq = [g.float().square().sum() for _, g in params_grads
              if g is not None]
        if not sq:
            return params_grads
        global_norm = torch.stack(sq).sum().sqrt()
        scale = self.clip_norm / global_norm.clamp_min(self.clip_norm)
        return [(p, None if g is None else _grad_scale(g, scale))
                for p, g in params_grads]
