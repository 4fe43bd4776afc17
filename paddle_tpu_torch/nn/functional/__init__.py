"""Functionals (counterpart: ``paddle_tpu/nn/functional``)."""
from .activation import gelu, relu, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401

__all__ = ["linear", "embedding", "dropout", "layer_norm", "gelu", "relu",
           "tanh", "scaled_dot_product_attention", "cross_entropy"]
