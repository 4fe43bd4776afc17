"""The AMP meta-optimizer (counterpart: ``meta_optimizers/amp.py``):
dynamic loss scaling through the port's ``amp.GradScaler`` with the
reference's ``amp_configs`` defaults; ``auto_cast`` does the casts. The
scaled step skips on the device where a gradient is not finite."""
from ....amp.grad_scaler import GradScaler
from ._wrapper import MetaOptimizer


class AMPOptimizer(MetaOptimizer):
    def __init__(self, inner_optimizer, amp_configs=None):
        super().__init__(inner_optimizer)
        cfg = dict(amp_configs or {})
        self._scaler = GradScaler(
            enable=True,
            init_loss_scaling=cfg.get("init_loss_scaling", 32768.0),
            incr_ratio=cfg.get("incr_ratio", 2.0),
            decr_ratio=cfg.get("decr_ratio", 0.5),
            incr_every_n_steps=cfg.get("incr_every_n_steps", 1000),
            decr_every_n_nan_or_inf=cfg.get("decr_every_n_nan_or_inf", 2),
            use_dynamic_loss_scaling=cfg.get("use_dynamic_loss_scaling",
                                             True))

    @property
    def scaler(self):
        return self._scaler

    def scale(self, loss):
        return self._scaler.scale(loss)

    def step(self):
        self._scaler.step(self._inner)

    def minimize(self, loss, *a, **k):
        self._scaler.scale(loss).backward()
        self._scaler.step(self._inner)
        self.clear_grad()
        return None, None
