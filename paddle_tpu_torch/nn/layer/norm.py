"""LayerNorm (counterpart: ``paddle_tpu/nn/layer/norm.py``)."""
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          is_bias=True, device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
