"""Probability distributions (counterpart: ``paddle_tpu/distribution.py``;
the reference framework's `python/paddle/distribution.py`: Distribution:42,
Uniform:169, Normal:391, Categorical:641).

The densities, entropies and KL terms are torch operations on the
distribution's device, written in the reference's order of operations, so
they agree with it to float32 rounding; gradients flow to ``Tensor``
parameters. Draws come from an explicit ``torch.Generator`` on the
distribution's device: one seeded with ``seed`` where ``sample`` takes
it, else the package's (``core.random``). JAX's threefry and torch's
Philox give different draws from the same seed, so the draws agree with
the reference's in distribution only. A distribution lives on the device
of its first ``Tensor`` parameter, else on ``device`` (the card unless it
says the CPU); ``Categorical`` draws by the Gumbel-max rule, as
``jax.random.categorical`` does, and returns int64 ids.
"""
import math

import torch

from .core.device import resolve_device
from .core.dispatch import call_op, call_op_nograd, unwrap, wrap
from .core.tensor import Tensor

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _device(params, device):
    for p in params:
        if isinstance(p, torch.Tensor):
            return unwrap(p).device
    return resolve_device(device)


def _as_tensor(x, device):
    """User ``Tensor``s stay as given (so gradients reach them); other
    tensors, scalars and arrays become float32 ``Tensor``s on ``device``."""
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return wrap(x)
    return Tensor(torch.as_tensor(x, dtype=torch.float32, device=device))


def _value(v, like):
    v = unwrap(v)
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.float32, device=unwrap(like).device)


def _generator(device, seed):
    from .core import random as core_random
    if not seed:
        return core_random.draw_generator(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


class Distribution:
    """The base class (reference: distribution.py:42)."""

    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high) (reference: distribution.py:169)."""

    def __init__(self, low, high, name=None, device=None):
        dev = _device((low, high), device)
        self.low = _as_tensor(low, dev)
        self.high = _as_tensor(high, dev)
        self.name = name or "Uniform"

    def sample(self, shape, seed=0):
        lo, hi = unwrap(self.low).detach(), unwrap(self.high).detach()
        base = torch.broadcast_shapes(lo.shape, hi.shape)
        u = torch.rand(tuple(shape) + tuple(base), dtype=torch.float32,
                       device=lo.device, generator=_generator(lo.device,
                                                              seed))
        return wrap(lo + u * (hi - lo))

    def log_prob(self, value):
        def f(v, lo, hi):
            inside = (v >= lo) & (v < hi)
            lp = -torch.log(hi - lo)
            return torch.where(inside, lp, torch.full_like(lp, -math.inf))
        return call_op(f, _value(value, self.low), self.low, self.high,
                       op_name="uniform_log_prob")

    def probs(self, value):
        def f(v, lo, hi):
            inside = (v >= lo) & (v < hi)
            p = 1.0 / (hi - lo)
            return torch.where(inside, p, torch.zeros_like(p))
        return call_op(f, _value(value, self.low), self.low, self.high,
                       op_name="uniform_probs")

    def entropy(self):
        return call_op_nograd(lambda lo, hi: torch.log(hi - lo),
                              self.low, self.high,
                              op_name="uniform_entropy")


class Normal(Distribution):
    """N(loc, scale) (reference: distribution.py:391)."""

    def __init__(self, loc, scale, name=None, device=None):
        dev = _device((loc, scale), device)
        self.loc = _as_tensor(loc, dev)
        self.scale = _as_tensor(scale, dev)
        self.name = name or "Normal"

    def sample(self, shape, seed=0):
        mu, sig = unwrap(self.loc).detach(), unwrap(self.scale).detach()
        base = torch.broadcast_shapes(mu.shape, sig.shape)
        z = torch.randn(tuple(shape) + tuple(base), dtype=torch.float32,
                        device=mu.device, generator=_generator(mu.device,
                                                               seed))
        return wrap(mu + z * sig)

    def log_prob(self, value):
        def f(v, mu, sig):
            var = sig * sig
            return (-((v - mu) ** 2) / (2 * var)
                    - torch.log(sig) - 0.5 * math.log(2 * math.pi))
        return call_op(f, _value(value, self.loc), self.loc, self.scale,
                       op_name="normal_log_prob")

    def probs(self, value):
        def f(v, mu, sig):
            var = sig * sig
            return (torch.exp(-((v - mu) ** 2) / (2 * var))
                    / (sig * math.sqrt(2 * math.pi)))
        return call_op(f, _value(value, self.loc), self.loc, self.scale,
                       op_name="normal_probs")

    def entropy(self):
        def f(sig):
            return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(sig)
        return call_op(f, self.scale, op_name="normal_entropy")

    def kl_divergence(self, other):
        """KL(self || other) of two Normals (reference: :596)."""
        def f(mu0, sig0, mu1, sig1):
            var_ratio = (sig0 / sig1) ** 2
            t1 = ((mu0 - mu1) / sig1) ** 2
            return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
        return call_op(f, self.loc, self.scale, other.loc, other.scale,
                       op_name="normal_kl")


def _log_softmax(lg):
    m = torch.amax(lg, dim=-1, keepdim=True)
    return lg - (torch.log(torch.sum(torch.exp(lg - m), dim=-1,
                                     keepdim=True)) + m)


def _gather_last(lp, idx):
    """Class ``idx`` per row: batched logits gather per row, 1-D logits
    broadcast over any ``idx`` shape."""
    if lp.dim() == 1:
        return lp[idx]
    return torch.gather(lp, -1, idx[..., None])[..., 0]


class Categorical(Distribution):
    """Categorical over unnormalized logits (reference:
    distribution.py:641): ``logits`` are unnormalized log-probabilities."""

    def __init__(self, logits, name=None, device=None):
        self.logits = _as_tensor(logits, _device((logits,), device))
        self.name = name or "Categorical"

    def sample(self, shape):
        lg = unwrap(self.logits).detach()
        u = torch.rand(tuple(shape) + tuple(lg.shape), dtype=lg.dtype,
                       device=lg.device,
                       generator=_generator(lg.device, 0))
        tiny = torch.finfo(lg.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return wrap(torch.argmax(lg + gumbel, dim=-1))

    def probs(self, value):
        idx = _value(value, self.logits).long()

        def f(lg):
            return _gather_last(torch.exp(_log_softmax(lg)), idx)
        return call_op(f, self.logits, op_name="categorical_probs")

    def log_prob(self, value):
        idx = _value(value, self.logits).long()

        def f(lg):
            return _gather_last(_log_softmax(lg), idx)
        return call_op(f, self.logits, op_name="categorical_log_prob")

    def entropy(self):
        def f(lg):
            lp = _log_softmax(lg)
            return -torch.sum(torch.exp(lp) * lp, dim=-1)
        return call_op(f, self.logits, op_name="categorical_entropy")

    def kl_divergence(self, other):
        """KL(self || other) (reference: :775)."""
        def f(a, b):
            la, lb = _log_softmax(a), _log_softmax(b)
            return torch.sum(torch.exp(la) * (la - lb), dim=-1)
        return call_op(f, self.logits, other.logits,
                       op_name="categorical_kl")
