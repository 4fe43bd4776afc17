"""Functionals (counterpart: ``paddle_tpu/nn/functional``)."""
from .activation import gelu  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .norm import layer_norm  # noqa: F401

__all__ = ["linear", "embedding", "dropout", "layer_norm", "gelu",
           "scaled_dot_product_attention"]
