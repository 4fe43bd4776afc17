"""The tensor-parallel RNG tracker (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/random.py``).

Inside a model-parallel region (the attention heads one mp rank holds) a
dropout must draw differently on each mp rank; on the replicated
activations every mp rank must draw the same. ``model_parallel_random_seed``
seeds the package's generators alike on every rank (``core.random.seed``)
and adds a ``model_parallel_rng`` state seeded ``seed + 1024 + mp rank``;
``get_rng_state_tracker().rng_state()`` makes that state the package's
generator for the block. Each state is a set of ``torch.Generator``\\ s, one
per device, created on first use.
"""
from contextlib import contextmanager

import torch

from ....core import random as core_random

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = {"seed": int(seed), "generators": {}}

    def get_states_tracker(self):
        return {n: {str(d): g.get_state() for d, g in s["generators"].items()}
                for n, s in self.states_.items()}

    def set_states_tracker(self, states):
        for name, by_dev in states.items():
            for dev, st in by_dev.items():
                self._generator(name, torch.device(dev)).set_state(st)

    def _generator(self, name, device):
        s = self.states_[name]
        g = s["generators"].get(device)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(s["seed"])
            s["generators"][device] = g
        return g

    @contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        """The package's draws in the block come from state ``name``."""
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        with core_random.generators_from(
                lambda dev: self._generator(name, dev)):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    """Seed the package alike on every rank and the model-parallel state
    per mp rank."""
    import random as pyrandom
    from ..base.topology import get_hybrid_communicate_group
    seed = seed if seed is not None else pyrandom.randint(0, 2 ** 31 - 1)
    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _tracker.reset()
    core_random.seed(seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)
