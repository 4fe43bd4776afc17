"""Functionals (counterpart: ``paddle_tpu/nn/functional``).

Each takes the reference's ``Tensor`` at its boundary
(``core.tensor.boundary``: plain tensors inside, ``Tensor`` results for
``Tensor`` inputs); called with plain tensors, as the port's layers call
them, it runs as written.
"""
from ...core.dispatch import call_op  # noqa: F401
from ...core.tensor import boundary as _boundary
from ...ops.manipulation import pad  # noqa: F401
from .activation import gelu, relu, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout, embedding, linear  # noqa: F401
from .conv import conv1d, conv2d, conv3d  # noqa: F401
from .loss import (binary_cross_entropy_with_logits,  # noqa: F401
                   cross_entropy)
from .norm import batch_norm, layer_norm  # noqa: F401
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      avg_pool3d, max_pool1d, max_pool2d, max_pool3d)
from .vision import (affine_channel, affine_grid, channel_shuffle,  # noqa: F401
                     deformable_conv, grid_sample, local_response_norm, lrn,
                     shuffle_channel, space_to_depth, temporal_shift)

__all__ = ["linear", "embedding", "dropout", "layer_norm", "batch_norm",
           "gelu", "relu", "tanh", "scaled_dot_product_attention",
           "cross_entropy", "binary_cross_entropy_with_logits", "conv1d",
           "conv2d", "conv3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_max_pool2d", "pad", "affine_grid", "grid_sample",
           "temporal_shift", "channel_shuffle", "shuffle_channel",
           "space_to_depth", "affine_channel", "local_response_norm", "lrn",
           "deformable_conv"]

# pad is an op of ``ops`` (Tensor in, Tensor out)
for _name in __all__:
    if _name != "pad":
        globals()[_name] = _boundary(globals()[_name], op_name=_name)
shuffle_channel = channel_shuffle  # noqa: F811
del _name
