"""Functionals (counterpart: ``paddle_tpu/nn/functional``).

Each takes the reference's ``Tensor`` at its boundary
(``core.tensor.boundary``: plain tensors inside, ``Tensor`` results for
``Tensor`` inputs); called with plain tensors, as the port's layers call
them, it runs as written.
"""
from ...core.dispatch import call_op  # noqa: F401
from ...core.tensor import boundary as _boundary
from ...ops.manipulation import pad  # noqa: F401
from . import activation as _activation
from . import common as _common
from . import loss as _loss
from .activation import *  # noqa: F401,F403
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import *  # noqa: F401,F403
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import *  # noqa: F401,F403
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_max_pool2d, avg_pool1d, avg_pool2d,
                      avg_pool3d, max_pool1d, max_pool2d,
                      max_pool2d_with_index, max_pool3d, max_unpool2d)
from .vision import (affine_channel, affine_grid, channel_shuffle,  # noqa: F401
                     deformable_conv, grid_sample, local_response_norm, lrn,
                     shuffle_channel, space_to_depth, temporal_shift)

__all__ = (_activation.__all__ + _common.__all__ + _loss.__all__ + [
    "layer_norm", "batch_norm", "rms_norm", "instance_norm", "group_norm",
    "scaled_dot_product_attention", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "max_pool2d_with_index", "max_unpool2d",
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_max_pool2d", "pad", "affine_grid", "grid_sample",
    "temporal_shift", "channel_shuffle", "shuffle_channel",
    "space_to_depth", "affine_channel", "local_response_norm", "lrn",
    "deformable_conv"])

# pad is an op of ``ops`` (Tensor in, Tensor out); swish is silu
for _name in __all__:
    if _name not in ("pad", "swish"):
        globals()[_name] = _boundary(globals()[_name], op_name=_name)
shuffle_channel = channel_shuffle  # noqa: F811
swish = silu  # noqa: F811
del _name
