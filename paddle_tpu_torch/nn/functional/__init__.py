"""Functionals (counterpart: ``paddle_tpu/nn/functional``)."""
from .activation import gelu, relu, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm, layer_norm  # noqa: F401
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      avg_pool3d, max_pool1d, max_pool2d, max_pool3d)

__all__ = ["linear", "embedding", "dropout", "layer_norm", "batch_norm",
           "gelu", "relu", "tanh", "scaled_dot_product_attention",
           "cross_entropy", "conv1d", "conv2d", "conv3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_max_pool2d"]
