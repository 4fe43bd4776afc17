"""The recompute meta-optimizer (counterpart: ``meta_optimizers/
recompute.py``): recompute is a property of the model, applied by
``apply_recompute`` (``fleet.distributed_model`` calls it under
``strategy.recompute``); the optimizer wrapper records what was wrapped."""
import fnmatch

from ._wrapper import MetaOptimizer


def apply_recompute(model, checkpoints):
    """Recompute (``full``) every sublayer whose structured name matches a
    pattern of ``checkpoints`` (fnmatch or substring) and that recomputes
    nothing yet; returns the names wrapped."""
    wrapped = []
    pats = list(checkpoints or [])
    if not pats:
        return wrapped
    for name, sub in model.named_sublayers():
        if getattr(sub, "_recompute_policy", None) is not None:
            continue  # applied once only
        if any(fnmatch.fnmatch(name, p) or p in name for p in pats):
            sub.enable_recompute("full")
            wrapped.append(name)
    return wrapped


class RecomputeOptimizer(MetaOptimizer):
    """The inner optimizer, with the names of the recomputed layers."""

    def __init__(self, inner_optimizer, wrapped_layers=()):
        super().__init__(inner_optimizer)
        self.wrapped_layers = list(wrapped_layers)
