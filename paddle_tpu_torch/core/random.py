"""Seeded generators (counterpart: ``paddle_tpu/core/random.py``, ``seed``).

All randomness of the package (weight init, dropout) draws from explicit
``torch.Generator`` objects, one per device, seeded by :func:`seed`;
torch's global RNG state is never read or advanced. JAX's threefry and
torch's Philox give different numbers from the same seed, so parity tests
make their inputs with numpy and move weights with ``bridge``.

Under CUDA-graph capture (``jit.to_static`` on the card) a draw is legal
only from a generator registered with the graph being captured
(:func:`register_with_graph`): torch then advances its offset on every
replay, so each replayed step draws a new mask. A draw from an unregistered
generator raises instead of freezing one mask into every replay.

:func:`capture_state` and :func:`restore_state` carry the generators'
states through a checkpoint. A restore sets each generator's state in
place (``Generator.set_state``): torch keeps one state object per
generator, which a graph registered with it reads at every replay, so a
restored state takes effect at the next replay.

:func:`get_rng_state` and :func:`set_rng_state` read and set one
device's generator (the reference's RNG state as one tensor).

:func:`generators_from` hands the package's draws in a block to other
generators (the tensor-parallel RNG tracker's states).
"""
import threading
from contextlib import contextmanager

import torch

from .device import resolve_device

_lock = threading.Lock()
_state = {"seed": 0, "generators": {}, "graph_safe": []}
_override = []  # generators_from's factories, innermost last


def seed(s):
    """``paddle.seed`` analog: reseed every generator of the package."""
    with _lock:
        _state["seed"] = int(s)
        _state["generators"].clear()


def generators():
    """``{device: torch.Generator}`` of the package's generators made so
    far (the memory ledger's ``rng`` entries)."""
    with _lock:
        return dict(_state["generators"])


def default_generator(device=None):
    """The package's generator for ``device`` (created on first use from
    the current seed)."""
    dev = resolve_device(device)
    if _override:
        return _override[-1](dev)
    with _lock:
        g = _state["generators"].get(dev)
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(_state["seed"])
            _state["generators"][dev] = g
        return g


@contextmanager
def generators_from(factory):
    """In the block the package draws from ``factory(device)`` instead of
    its own generators (the tensor-parallel RNG tracker's states)."""
    _override.append(factory)
    try:
        yield
    finally:
        _override.pop()


def draw_generator(device):
    """The generator a random draw on ``device`` takes; raises
    ``NotImplementedError`` under graph capture unless that generator is
    registered with the graph."""
    g = default_generator(device)
    if (g.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
            and not any(g is r for r in _state["graph_safe"])):
        raise NotImplementedError(
            "a random draw under CUDA-graph capture needs the package's "
            "generator registered with the graph (CUDAGraph."
            "register_generator_state); without it every replay would "
            "repeat the mask drawn at capture")
    return g


def register_with_graph(graph, device):
    """Register the package's generator for ``device`` with ``graph``
    before its capture begins, where this torch can (``CUDAGraph.
    register_generator_state``); returns whether it did. Unregistered, a
    draw under the capture raises (:func:`draw_generator`)."""
    if not hasattr(graph, "register_generator_state"):
        return False
    g = default_generator(device)
    graph.register_generator_state(g)
    with _lock:
        if not any(g is r for r in _state["graph_safe"]):
            _state["graph_safe"].append(g)
    return True


def get_rng_state(device=None):
    """The state of the package's generator for ``device`` (default: the
    card) as a uint8 ``Tensor`` on the CPU (``Generator.get_state``)."""
    from .tensor import Tensor
    return Tensor(default_generator(device).get_state())


def set_rng_state(state, device=None):
    """Set the package's generator for ``device`` to a state that
    :func:`get_rng_state` gave, in place: the next draws repeat the ones
    that followed it."""
    from .tensor import unwrap
    default_generator(device).set_state(
        unwrap(state).detach().to("cpu", torch.uint8).clone())


def capture_state():
    """``{"seed": the package's seed, "generators": {device: state}}``,
    each state a uint8 numpy array (``Generator.get_state``)."""
    with _lock:
        gens = dict(_state["generators"])
        out = {"seed": _state["seed"], "generators": {}}
    for dev, g in gens.items():
        out["generators"][str(dev)] = g.get_state().numpy().copy()
    return out


def restore_state(state):
    """Set the package's seed and each saved device's generator to a
    :func:`capture_state` record, in place (outside any capture)."""
    with _lock:
        _state["seed"] = int(state["seed"])
    for dev, arr in state["generators"].items():
        default_generator(dev).set_state(torch.from_numpy(arr.copy()))
