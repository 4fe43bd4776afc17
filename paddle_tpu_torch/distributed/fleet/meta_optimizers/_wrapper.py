"""The wrapper surface the meta-optimizers share."""


class MetaOptimizer:
    """Holds ``_inner``; every attribute it does not define is the inner
    optimizer's. ``step`` is the wrapper's own."""

    def __init__(self, inner_optimizer):
        self._inner = inner_optimizer

    def __getattr__(self, name):
        if name == "_inner":  # not set yet (unpickling, a failed init)
            raise AttributeError(name)
        return getattr(self._inner, name)

    def step(self):
        self._inner.step()

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None
