"""LR schedulers (counterpart: ``paddle_tpu/optimizer/lr.py``).

Schedulers run on the host and write the new rate into the optimizer they
are bound to. As in paddle, construction primes the scheduler with one
``step()`` (epoch 0).
"""
import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self._owner = None
        self.last_lr = None
        self.step()  # prime to epoch 0 (paddle semantics)

    def _bind(self, lr_value):
        self._owner = lr_value
        self._push()

    def _push(self):
        if self._owner is not None:
            self._owner.set(self.last_lr)

    def get_lr(self):
        raise NotImplementedError

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        self._push()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state.get("last_epoch", -1)
        self.last_lr = state.get("last_lr", self.base_lr)
        self._push()


class LinearWarmup(LRScheduler):
    """Linear from ``start_lr`` to ``end_lr`` over ``warmup_steps``, then
    ``learning_rate`` (a float, or a scheduler shifted by the warm-up)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if isinstance(self.lr, LRScheduler):
            self.lr.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr.get_lr()
        return self.lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class PiecewiseDecay(LRScheduler):
    """``values[i]`` while ``last_epoch < boundaries[i]``, then the last
    value."""

    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]
