"""AMP, bf16-first mixed precision (counterpart: ``paddle_tpu/amp``).

``auto_cast`` with the reference's op lists. bf16 has float32's exponent
range, so the bf16 path needs no loss scaling; ``GradScaler`` is not ported
yet.
"""
from .auto_cast import (auto_cast, black_list,  # noqa: F401
                        downcast_out_list, get_amp_state, white_list)

__all__ = ["auto_cast", "white_list", "black_list", "downcast_out_list",
           "get_amp_state"]
