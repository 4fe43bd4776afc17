"""Activation layers (counterpart: ``paddle_tpu/nn/layer/activation.py``):
each calls its functional with the arguments it was built with."""
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return F.relu6(x)


class Sigmoid(Layer):
    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Silu(Layer):
    def forward(self, x):
        return F.silu(x)


class Swish(Silu):
    pass


class Mish(Layer):
    def forward(self, x):
        return F.mish(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class SELU(Layer):
    def forward(self, x):
        return F.selu(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardsigmoid(Layer):
    def forward(self, x):
        return F.hardsigmoid(x)


class Hardswish(Layer):
    def forward(self, x):
        return F.hardswish(x)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Tanhshrink(Layer):
    def forward(self, x):
        return F.tanhshrink(x)


class Softsign(Layer):
    def forward(self, x):
        return F.softsign(x)


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class PReLU(Layer):
    """One slope (``num_parameters=1``) or one per channel, each ``init``
    (the reference keeps ``data_format`` and reads channels on axis 1)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr, device=device,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)
