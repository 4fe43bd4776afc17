"""Seeded generators (counterpart: ``paddle_tpu/core/random.py``, ``seed``).

All randomness of the package (weight init, dropout) draws from explicit
``torch.Generator`` objects, one per device, seeded by :func:`seed`;
torch's global RNG state is never read or advanced. JAX's threefry and
torch's Philox give different numbers from the same seed, so parity tests
make their inputs with numpy and move weights with ``bridge``.
"""
import threading

import torch

from .device import resolve_device

_lock = threading.Lock()
_state = {"seed": 0, "generators": {}}


def seed(s):
    """``paddle.seed`` analog: reseed every generator of the package."""
    with _lock:
        _state["seed"] = int(s)
        _state["generators"].clear()


def default_generator(device=None):
    """The package's generator for ``device`` (created on first use from
    the current seed)."""
    dev = resolve_device(device)
    with _lock:
        g = _state["generators"].get(dev)
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(_state["seed"])
            _state["generators"][dev] = g
        return g
