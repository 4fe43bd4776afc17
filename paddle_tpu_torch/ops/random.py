"""Random ops (counterpart: ``paddle_tpu/ops/random.py``).

Every draw takes the package's generator for its device through
``core.random.draw_generator`` (so a draw inside a captured program needs
that generator registered with the graph, and a draw outside replays
after ``set_rng_state``). jax's threefry and torch's Philox give other
numbers from one seed: the port matches the reference's distributions,
shapes and dtypes, not its values. The ``device`` keyword is the port's
(the card unless it says the CPU).
"""
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.random import draw_generator
from .math import op, shape_list, tensor_like

__all__ = ["rand", "randn", "normal", "uniform", "randint", "randperm",
           "shuffle", "bernoulli", "multinomial", "truncated_normal"]


def _draw(device):
    dev = resolve_device(device)
    return dev, draw_generator(dev)


@op
def rand(shape, dtype="float32", device=None):
    dev, g = _draw(device)
    return torch.rand(shape_list(shape), generator=g, device=dev,
                      dtype=convert_dtype(dtype))


@op
def randn(shape, dtype="float32", device=None):
    dev, g = _draw(device)
    return torch.randn(shape_list(shape), generator=g, device=dev,
                       dtype=convert_dtype(dtype))


@op
def normal(mean=0.0, std=1.0, shape=None, device=None):
    dev, g = _draw(device)
    z = torch.randn(shape_list(shape), generator=g, device=dev)
    return z * std + mean


@op
def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0,  # noqa: A002
            device=None):
    """U[min, max); a nonzero ``seed`` draws from a generator of its own
    seeded with it (the package's stays where it was)."""
    dev, g = _draw(device)
    if seed:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
    u = torch.rand(shape_list(shape), generator=g, device=dev,
                   dtype=convert_dtype(dtype))
    return u * (max - min) + min


@op
def randint(low=0, high=None, shape=(1,), dtype="int64", device=None):
    if high is None:
        low, high = 0, low
    dev, g = _draw(device)
    return torch.randint(int(low), int(high), shape_list(shape),
                         generator=g, device=dev, dtype=convert_dtype(dtype))


@op
def randperm(n, dtype="int64", device=None):
    dev, g = _draw(device)
    return torch.randperm(int(n), generator=g, device=dev,
                          dtype=convert_dtype(dtype))


@op
def shuffle(x, axis=0):
    g = draw_generator(x.device)
    perm = torch.randperm(x.shape[axis], generator=g, device=x.device)
    return x.index_select(axis, perm)


@op
def bernoulli(x):
    x = tensor_like(x, None)
    return torch.bernoulli(x, generator=draw_generator(x.device))


@op
def multinomial(x, num_samples=1, replacement=False):
    x = tensor_like(x, None)
    return torch.multinomial(x.float(), num_samples, replacement,
                             generator=draw_generator(x.device))


@op
def truncated_normal(shape, mean=0.0, std=1.0, dtype="float32", device=None):
    """A standard normal truncated to [-2, 2], then scaled by ``std`` and
    moved by ``mean``."""
    dev, g = _draw(device)
    z = torch.empty(shape_list(shape), device=dev, dtype=torch.float32)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=g)
    return (z * std + mean).to(convert_dtype(dtype))
