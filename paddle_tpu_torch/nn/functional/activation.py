"""Activation functionals (counterpart:
``paddle_tpu/nn/functional/activation.py``).

Each passes its inputs through :func:`cast_inputs` under the reference's
op name, so ``auto_cast`` treats it as the reference's dispatch does: at
level O1 only ``softmax`` and ``log_softmax`` are listed (block list: they
compute in float32, and return the AMP dtype when their input came in it);
at O2 every float32 input is cast to the AMP dtype. The formulas are the
reference's (``selu``'s, ``softplus``'s threshold, ``hardsigmoid``'s
slope and offset), written in torch ops.

``gumbel_softmax`` draws its noise from the package's generator for the
input's device (``core.random.draw_generator``): torch's and JAX's streams
differ, so the tests hold the computation after the draw at the same
noise (:func:`gumbel_softmax_from_noise`) and the draw by its moments.
"""
import torch

from ...amp.auto_cast import cast_inputs, downcast_dtype
from ...core.dtype import convert_dtype
from ...core.random import draw_generator

__all__ = ["relu", "relu6", "sigmoid", "tanh", "gelu", "silu", "swish",
           "mish", "leaky_relu", "elu", "selu", "celu", "hardshrink",
           "softshrink", "tanhshrink", "hardtanh", "hardsigmoid",
           "hardswish", "softplus", "softsign", "thresholded_relu",
           "log_sigmoid", "softmax", "log_softmax", "gumbel_softmax",
           "prelu", "glu", "maxout"]

_F = torch.nn.functional


def _unary(name, fn, x):
    (x,) = cast_inputs(name, x)
    return fn(x)


def gelu(x, approximate=False):
    """Exact (erf) GELU by default, as GPT uses it; tanh form on request."""
    return _unary("gelu", lambda v: _F.gelu(
        v, approximate="tanh" if approximate else "none"), x)


def relu(x):
    return _unary("relu", torch.relu, x)


def tanh(x):
    return _unary("tanh", torch.tanh, x)


def relu6(x):
    return _unary("relu6", lambda v: v.clamp(0.0, 6.0), x)


def sigmoid(x):
    return _unary("sigmoid", torch.sigmoid, x)


def silu(x):
    return _unary("silu", _F.silu, x)


swish = silu


def mish(x):
    return _unary("mish", lambda v: v * torch.tanh(_F.softplus(v)), x)


def leaky_relu(x, negative_slope=0.01):
    return _unary("leaky_relu", lambda v: _F.leaky_relu(v, negative_slope),
                  x)


def elu(x, alpha=1.0):
    return _unary("elu", lambda v: _F.elu(v, alpha), x)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return _unary("selu", lambda v: scale * torch.where(
        v > 0, v, alpha * torch.expm1(v)), x)


def celu(x, alpha=1.0):
    return _unary("celu", lambda v: _F.celu(v, alpha), x)


def hardshrink(x, threshold=0.5):
    return _unary("hardshrink", lambda v: torch.where(
        v.abs() > threshold, v, 0.0), x)


def softshrink(x, threshold=0.5):
    return _unary("softshrink", lambda v: torch.where(
        v > threshold, v - threshold,
        torch.where(v < -threshold, v + threshold, 0.0)), x)


def tanhshrink(x):
    return _unary("tanhshrink", lambda v: v - torch.tanh(v), x)


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return _unary("hardtanh", lambda v: v.clamp(min, max), x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return _unary("hardsigmoid",
                  lambda v: (v * slope + offset).clamp(0.0, 1.0), x)


def hardswish(x):
    return _unary("hardswish",
                  lambda v: v * (v + 3.0).clamp(0.0, 6.0) / 6.0, x)


def softplus(x, beta=1.0, threshold=20.0):
    """``log1p(exp(beta x)) / beta``, and ``x`` itself where ``beta x``
    passes ``threshold`` (the reference's branch; torch's own softplus
    compares ``beta x`` the same way)."""
    return _unary("softplus", lambda v: torch.where(
        v * beta > threshold, v, torch.log1p(torch.exp(beta * v)) / beta), x)


def softsign(x):
    return _unary("softsign", _F.softsign, x)


def thresholded_relu(x, threshold=1.0):
    return _unary("thresholded_relu",
                  lambda v: torch.where(v > threshold, v, 0.0), x)


def log_sigmoid(x):
    return _unary("log_sigmoid", _F.logsigmoid, x)


def _normalized(name, fn, x):
    """A block-listed, downcast op: float32 compute under AMP, the AMP
    dtype back when the input came in it."""
    out_dtype = downcast_dtype(name, x)
    (x,) = cast_inputs(name, x)
    out = fn(x)
    return out if out_dtype is None else out.to(out_dtype)


def softmax(x, axis=-1, dtype=None):
    def _softmax(v):
        if dtype is not None:
            v = v.to(convert_dtype(dtype))
        return torch.softmax(v, dim=axis)
    return _normalized("softmax", _softmax, x)


def log_softmax(x, axis=-1):
    return _normalized("log_softmax",
                       lambda v: torch.log_softmax(v, dim=axis), x)


def gumbel_softmax_from_noise(x, g, temperature=1.0, hard=False, axis=-1):
    """``gumbel_softmax`` at given Gumbel noise ``g``: ``softmax((x + g)
    / temperature)``, and with ``hard`` the one-hot of its argmax with the
    soft result's gradient (straight through)."""
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    (x,) = cast_inputs("gumbel_softmax", x)
    u = torch.rand(x.shape, generator=draw_generator(x.device),
                   device=x.device, dtype=torch.float32)
    # -log(-log u): the standard Gumbel's inverse CDF (u in [0, 1), a 0
    # clamped to the smallest normal float32)
    tiny = torch.finfo(torch.float32).tiny
    g = (-torch.log(-torch.log(u.clamp_min(tiny)))).to(x.dtype)
    return gumbel_softmax_from_noise(x, g, temperature, hard, axis)


def prelu(x, weight):
    """``x`` where ``x >= 0``, else ``weight * x``: one weight, or one per
    channel (axis 1)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        w = weight.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1] = weight.numel()
        w = weight.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def glu(x, axis=-1):
    def _glu(v):
        a, b = torch.chunk(v, 2, dim=axis)
        return a * torch.sigmoid(b)
    return _unary("glu", _glu, x)


def maxout(x, groups, axis=1):
    def _maxout(v):
        ax = axis % v.dim()
        shape = list(v.shape)
        shape[ax] = shape[ax] // groups
        shape.insert(ax + 1, groups)
        return v.reshape(shape).amax(dim=ax + 1)
    return _unary("maxout", _maxout, x)
