"""Parameter averaging (counterpart: ``paddle_tpu/optimizer/averaging.py``):
``ModelAverage``, ``ExponentialMovingAverage`` and ``LookAhead``.

Their state is float32 tensors on the parameters' device, made when the
parameters are known and updated in place; every gate (the window's
restart and its spill, LookAhead's sync every k steps, the EMA's warm-up
decay) is a ``torch.where`` on a device flag, so a step reads nothing on
the host and runs inside a captured k-step program. ``apply`` is a context
manager that writes the averaged values into the parameters in place and
restores them on exit.

LookAhead's reset writes the inner optimizer's float32 master too, where
it keeps one: the reference writes the parameter only, and the master,
from which the next step computes the parameter, undoes the reset (ROADMAP
§3, "Reference faults").
"""
import contextlib

import torch

from .optimizer import Optimizer


def _zeros_like(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class ModelAverage(Optimizer):
    """The average of the parameters over a bounded window: the running
    sum ``sum_1`` spills into ``sum_2`` every 16384 updates, and both roll
    into ``sum_3`` when the window reaches ``max(min_average_window, rate
    * updates)`` (at most ``max_average_window``); ``apply`` averages over
    the current and the previous window."""

    _KMAX_BLOCK = 16384.0  # the reference's kMaxNumAccumulates spill

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000000,
                 name=None):
        super().__init__(learning_rate=0.0,
                         parameters=[] if parameters is None else parameters)
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        params = list(self._parameters())
        self._sum1 = {id(p): _zeros_like(p) for p in params}
        self._sum2 = {id(p): _zeros_like(p) for p in params}
        self._sum3 = {id(p): _zeros_like(p) for p in params}
        dev = self._step_count.device
        scalar = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        self._num_accum = scalar()
        self._old_num_accum = scalar()
        self._num_updates = scalar()
        self._saved = None

    @torch.no_grad()
    def step(self):
        self._num_updates.add_(1.0)
        n = self._num_accum + 1.0
        spill = (self._num_updates % self._KMAX_BLOCK) == 0
        window = (self._rate * self._num_updates).clamp_max(
            float(self._max_w))
        restart = (n >= float(self._min_w)) & (n >= window)
        for p in self._parameters():
            s1, s2, s3 = (self._sum1[id(p)], self._sum2[id(p)],
                          self._sum3[id(p)])
            acc1 = s1 + p.float()
            acc2 = torch.where(spill, s2 + acc1, s2)
            acc1 = torch.where(spill, 0.0, acc1)
            s3.copy_(torch.where(restart, acc1 + acc2, s3))
            s2.copy_(torch.where(restart, 0.0, acc2))
            s1.copy_(torch.where(restart, 0.0, acc1))
        self._old_num_accum.copy_(torch.where(restart, n,
                                              self._old_num_accum))
        self._num_accum.copy_(torch.where(restart, 0.0, n))

    minimize = None  # applied beside a real optimizer, not instead of it

    def apply(self, executor=None, need_restore=True):
        """The parameters swapped to their window average in the block
        (``with model_average.apply(): ...``); restored after it unless
        ``need_restore`` is False."""
        return self._apply_ctx(need_restore)

    @contextlib.contextmanager
    def _apply_ctx(self, need_restore):
        params = list(self._parameters())
        with torch.no_grad():
            self._saved = {id(p): p.detach().clone() for p in params}
            total = self._num_accum + self._old_num_accum
            for p in params:
                acc = (self._sum1[id(p)] + self._sum2[id(p)]
                       + self._sum3[id(p)])
                # no accumulation yet: the parameter stays as it is
                avg = torch.where(total > 0, acc / total.clamp_min(1.0),
                                  p.float())
                p.copy_(avg)
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._saved is not None:
            for p in self._parameters():
                if id(p) in self._saved:
                    p.copy_(self._saved[id(p)])
            self._saved = None


class ExponentialMovingAverage:
    """The EMA of the parameters: ``ema = d * ema + (1 - d) * p`` from zero,
    with ``d = min(decay, (1 + t) / (10 + t))`` under ``thres_steps``;
    ``apply`` writes ``ema / (1 - decay^t)`` (the zero start's bias
    correction) into the parameters."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._step = None  # made on the parameters' device at first update
        self._ema = {}
        self._params = []
        self._saved = None

    def _track(self, parameters):
        for p in parameters:
            if id(p) not in self._ema:
                self._params.append(p)
                self._ema[id(p)] = _zeros_like(p)
                if self._step is None:
                    self._step = torch.zeros((), dtype=torch.float32,
                                             device=p.device)

    @torch.no_grad()
    def update(self, parameters=None):
        """Fold the current values of ``parameters`` (default: every live
        ``Parameter`` of the state registry, ``core.state``) in."""
        if parameters is None:
            from ..core import state as state_mod
            from ..core.tensor import Parameter
            parameters = [t for _, t in state_mod.snapshot()
                          if isinstance(t, Parameter)]
        self._track(parameters)
        if self._step is None:
            return
        self._step.add_(1.0)
        decay = self._decay
        if self._thres_steps is not None:
            t = self._step
            decay = ((1.0 + t) / (10.0 + t)).clamp_max(self._decay)
        for p in self._params:
            e = self._ema[id(p)]
            e.copy_(decay * e + (1.0 - decay) * p.float())

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        with torch.no_grad():
            self._saved = {id(p): p.detach().clone() for p in self._params}
            if self._params:
                t = self._step
                corr = 1.0 - torch.pow(self._decay, t.clamp_min(1.0))
                for p in self._params:
                    corrected = self._ema[id(p)] / corr
                    # before any update the shadow is empty: live weights
                    p.copy_(torch.where(t > 0, corrected, p.float()))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._saved is not None:
            for p in self._params:
                if id(p) in self._saved:
                    p.copy_(self._saved[id(p)])
            self._saved = None


class LookAhead:
    """The inner (fast) optimizer steps; every ``k``-th step the slow
    weights move ``slow += alpha * (fast - slow)`` and the fast weights
    (and the inner optimizer's masters) reset to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self._alpha = alpha
        self._k = int(k)
        params = list(inner_optimizer._parameters())
        dev = params[0].device if params else torch.device("cpu")
        self._la_step = torch.zeros((), dtype=torch.int32, device=dev)
        self._slow = {id(p): p.detach().float().clone() for p in params}

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)

    def _parameters(self):
        return self.inner_optimizer._parameters()

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._la_step.add_(1)
        sync = (self._la_step % self._k) == 0
        for p in self._parameters():
            slow = self._slow[id(p)]
            new_slow = slow + self._alpha * (p.float() - slow)
            slow.copy_(torch.where(sync, new_slow, slow))
            p.copy_(torch.where(sync, new_slow.to(p.dtype), p))
            master = self.inner_optimizer._master_of(p)
            if master is not None:
                master.copy_(torch.where(sync, new_slow, master))

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None
