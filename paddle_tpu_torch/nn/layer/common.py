"""The common layers (counterpart: ``paddle_tpu/nn/layer/common.py``):
``Linear``, ``Embedding``, ``Dropout``, ``Dropout2D``, ``Flatten``,
``Identity``, ``Upsample``, ``Pad1D``/``Pad2D``, ``CosineSimilarity``,
``Bilinear`` and ``PixelShuffle``."""
import torch

from ... import ops
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class Linear(Layer):
    """y = xW + b with W: [in, out], as in the reference (no b with
    ``bias_attr=False``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr, device=device,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.weight.shape[0]}, out={self.weight.shape[1]}"


class Embedding(Layer):
    """A lookup table ``[num_embeddings, embedding_dim]`` (rows of
    ``padding_idx`` zero). With ``sparse=True`` the table's gradient is a
    ``SelectedRows`` of the looked-up rows (``F.embedding``), which the
    optimizers apply row by row."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None):
        super().__init__()
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr, device=device,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return ops.plain.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.data_format)


class Pad1D(Layer):
    """``F.pad`` with the reference's reading of ``padding`` (pairs in
    axis order over the trailing axes)."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad.__wrapped__(x, self.padding, self.mode, self.value,
                                 self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__(padding, mode, value, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """``W: [out, in1, in2]`` (Xavier) and a zero bias of ``[out]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, device=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            device=device)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True, device=device)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)
