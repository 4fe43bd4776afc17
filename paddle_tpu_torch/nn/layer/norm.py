"""LayerNorm, RMSNorm, GroupNorm, the instance norms and the BatchNorm
layers (counterpart: ``paddle_tpu/nn/layer/norm.py``). As in the
reference, ``InstanceNorm1D``, ``2D`` and ``3D`` are one class (it
normalises over whatever spatial axes its input has); ``SyncBatchNorm``
is not ported (ROADMAP item 19)."""
import torch

from ...core.device import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True,
            device=device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)


class InstanceNorm2D(Layer):
    """Scale (ones) and shift (zeros) per channel; ``momentum`` is taken
    and unused, as in the reference (no running statistics)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class _BatchNormBase(Layer):
    """Scale (ones) and shift (zeros), or as ``weight_attr``/``bias_attr``
    say (none where False); the running statistics are the float32
    buffers ``_mean`` (zeros) and ``_variance`` (ones), the reference's
    ``state_dict`` names. ``momentum`` is the reference's (the old
    value's weight)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, device=device,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, device=device)
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The fluid-style name of the same layer."""


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, name=name, device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, name=name, device=device)


class LocalResponseNorm(Layer):
    """``F.local_response_norm`` as a layer (no parameters)."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)
