"""AMP, bf16-first mixed precision (counterpart: ``paddle_tpu/amp``).

``auto_cast`` with the reference's op lists, and ``GradScaler``, the
dynamic loss scaling that float16 needs (bf16 has float32's exponent
range and needs none).
"""
from .auto_cast import (amp_guard, auto_cast, black_list,  # noqa: F401
                        downcast_out_list, get_amp_state, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "white_list", "black_list", "downcast_out_list",
           "get_amp_state", "GradScaler", "AmpScaler", "decorate"]


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at ``O2`` the models' parameters are cast
    to ``dtype`` (the optimizers keep float32 masters with
    ``multi_precision``); returns the models, and the optimizers when
    given."""
    if level == "O2":
        if not isinstance(models, (list, tuple)):
            models = [models]
        for m in models:
            m.to(dtype=dtype)
        models = models[0] if len(models) == 1 else models
    if optimizers is None:
        return models
    return models, optimizers
