"""gelu, relu, tanh (counterpart: ``paddle_tpu/nn/functional/activation.py``).

None of the three is on the reference's AMP lists, so under ``auto_cast``
at level O1 each keeps its input's dtype; at O2 :func:`cast_inputs` casts a
float32 input to the AMP dtype, as the reference's dispatch does.
"""
import torch

from ...amp.auto_cast import cast_inputs


def gelu(x, approximate=False):
    """Exact (erf) GELU by default, as GPT uses it; tanh form on request."""
    (x,) = cast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def tanh(x):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)
