"""Conv1D, Conv2D, Conv3D, Conv1DTranspose and Conv2DTranspose
(counterpart: ``paddle_tpu/nn/layer/conv.py``; the reference has no
``Conv3DTranspose`` layer).

Weights ``[out, in/groups, *k]`` (the transposed layers: ``[in,
out/groups, *k]``) drawn from ``KaimingUniform(fan_in)`` with ``fan_in =
in/groups * prod(k)`` as in the reference, unless ``weight_attr`` gives an
initializer; a zero bias unless ``bias_attr`` gives one or is False (no
bias).
"""
import math

from .. import functional as F
from .. import initializer as I
from .layers import Layer


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW", device=None,
                 transposed=False, output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = _ntuple(stride, nd)
        self._padding = padding
        self._dilation = _ntuple(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        self._nd = nd
        self._transposed = transposed
        self._output_padding = output_padding
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        shape = ([in_channels, out_channels // groups] if transposed
                 else [out_channels, in_channels // groups])
        self.weight = self.create_parameter(
            [*shape, *self._kernel_size], attr=weight_attr, device=device,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True, device=device)

    def forward(self, x):
        if self._transposed:
            conv = (F.conv1d_transpose, F.conv2d_transpose)[self._nd - 1]
            return conv(x, self.weight, self.bias, self._stride,
                        self._padding, self._output_padding, self._dilation,
                        self._groups, self._data_format)
        conv = (F.conv1d, F.conv2d, F.conv3d)[self._nd - 1]
        return conv(x, self.weight, self.bias, self._stride, self._padding,
                    self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device, transposed=True,
                         output_padding=output_padding)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, device, transposed=True,
                         output_padding=output_padding)
