"""Linear, Embedding, Dropout (counterpart: ``paddle_tpu/nn/layer/common.py``)."""
import torch

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
