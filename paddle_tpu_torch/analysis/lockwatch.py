"""The runtime lock-order watchdog's public surface (counterpart:
``paddle_tpu/analysis/lockwatch.py``): the factories and the inspection
functions of ``paddle_tpu_torch._lockwatch``."""
from .._lockwatch import (ENV_VAR, Condition, Lock, RLock,  # noqa: F401
                          disable, enable, enabled, held_names, reset,
                          snapshot, violations)

__all__ = ["Lock", "RLock", "Condition", "enable", "disable", "enabled",
           "reset", "held_names", "violations", "snapshot", "ENV_VAR"]
