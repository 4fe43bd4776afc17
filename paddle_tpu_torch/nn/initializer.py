"""Weight initializers (counterpart: ``paddle_tpu/nn/initializer``).

Each initializer draws on the target device from the package's seeded
generator (``core.random.default_generator``), so a full-width model is
initialized on the card without a host round trip (``Assign`` copies the
array it is given).
"""
import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.random import default_generator


class Initializer:
    def __call__(self, shape, dtype="float32", device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        return torch.full(tuple(shape), self.value,
                          dtype=convert_dtype(dtype),
                          device=resolve_device(device))


def _normal(shape, dtype, device, mean, std):
    dev = resolve_device(device)
    x = torch.randn(tuple(shape), generator=default_generator(dev),
                    device=dev, dtype=torch.float32)
    return (x * std + mean).to(convert_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        return _normal(shape, dtype, device, self.mean, self.std)


class TruncatedNormal(Initializer):
    """Normal draws truncated to two standard deviations of the mean (the
    reference's ``truncated_normal(-2, 2)``), scaled and shifted."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        dev = resolve_device(device)
        x = torch.empty(tuple(shape), device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=default_generator(dev))
        return (x * self.std + self.mean).to(convert_dtype(dtype))


def _uniform(shape, dtype, device, low, high):
    dev = resolve_device(device)
    u = torch.rand(tuple(shape), generator=default_generator(dev),
                   device=dev, dtype=torch.float32)
    return (u * (high - low) + low).to(convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device=None):
        return _uniform(shape, dtype, device, self.low, self.high)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _normal(shape, dtype, device, 0.0, std)


class XavierUniform(Initializer):
    """Uniform in +-gain * sqrt(6 / (fan_in + fan_out))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(
            6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return _uniform(shape, dtype, device, -limit, limit)


def _kaiming_gain(negative_slope):
    return math.sqrt(2.0 / (1 + negative_slope ** 2))


class KaimingNormal(Initializer):
    """Normal with std gain / sqrt(fan_in), gain sqrt(2 / (1 +
    negative_slope^2))."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", device=None):
        fi = self.fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.negative_slope) / math.sqrt(fi)
        return _normal(shape, dtype, device, 0.0, std)


class KaimingUniform(Initializer):
    """Uniform in +-gain * sqrt(3 / fan_in), gain sqrt(2 / (1 +
    negative_slope^2)) (the convolutions' default)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype="float32", device=None):
        fi = self.fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.negative_slope) * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, device, -limit, limit)


class Assign(Initializer):
    """The given array, whose shape must be the parameter's."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        arr = np.asarray(self.value)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape {arr.shape} != "
                             f"param shape {tuple(shape)}")
        return torch.tensor(arr, dtype=convert_dtype(dtype),
                            device=resolve_device(device))
