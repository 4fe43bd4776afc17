"""AMP, bf16-first mixed precision (counterpart: ``paddle_tpu/amp``).

``auto_cast`` with the reference's op lists, and ``GradScaler``, the
dynamic loss scaling that float16 needs (bf16 has float32's exponent
range and needs none).
"""
from .auto_cast import (auto_cast, black_list,  # noqa: F401
                        downcast_out_list, get_amp_state, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "white_list", "black_list", "downcast_out_list",
           "get_amp_state", "GradScaler", "AmpScaler"]
