"""LR schedulers (counterpart: ``paddle_tpu/optimizer/lr.py``).

Schedulers run on the host and write the new rate into the optimizer they
are bound to (``optimizer._LRValue.set``: the device's rate tensor in
place). As in paddle, construction primes the scheduler with one
``step()`` (epoch 0). A k-step program (``jit.to_static(...,
scan_steps=k)``) reads the rate tensor on every replay and refuses a
``set`` inside its capture, so step a scheduler between calls.
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


class NoamDecay(LRScheduler):
    """``learning_rate * d_model^-0.5 * min(step^-0.5, step *
    warmup_steps^-1.5)``, step at least 1 (the Transformer's schedule)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5
                * min(step ** -0.5, step * self.warmup_steps ** -1.5))


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    """``(lr - end_lr) * (1 - step / decay_steps)^power + end_lr``; with
    ``cycle`` the horizon grows by whole ``decay_steps``, else the step
    stops at it."""

    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr)
                * (1 - step / decay_steps) ** self.power + self.end_lr)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch
                                             // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceOnPlateau(LRScheduler):
    """Multiplies the rate by ``factor`` (not below ``min_lr``) once the
    metric given to ``step(metrics)`` has not improved for more than
    ``patience`` steps, then waits ``cooldown`` steps. The metric is read
    on the host (a tensor's ``item()``), between calls of a program."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self._current = learning_rate
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self._current

    def step(self, metrics=None, epoch=None):
        if metrics is None:  # the priming call of the base __init__
            self.last_epoch += 1
            self.last_lr = self.get_lr()
            self._push()
            return
        current = float(metrics.item() if hasattr(metrics, "item")
                        else metrics)
        self.last_epoch += 1
        if self.best is None or self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self._current * self.factor, self.min_lr)
            if self._current - new_lr > self.epsilon:
                self._current = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        self.last_lr = self._current
        self._push()

    def _is_better(self, current):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best * (1 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best * (1 + self.threshold)
        return current > self.best + self.threshold


class OneCycleLR(LRScheduler):
    """From ``max_learning_rate / divide_factor`` up to the maximum over
    ``phase_pct`` of ``total_steps``, then down to
    ``end_learning_rate``, by cosine (``anneal_strategy="cos"``) or
    linearly."""

    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_up = int(total_steps * phase_pct)
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        if step <= self.phase_up:
            pct = step / max(self.phase_up, 1)
            return self._interp(self.initial_lr, self.max_lr, pct)
        pct = ((step - self.phase_up)
               / max(self.total_steps - self.phase_up, 1))
        return self._interp(self.max_lr, self.end_lr, pct)
