"""gelu (counterpart: ``paddle_tpu/nn/functional/activation.py``)."""
import torch


def gelu(x, approximate=False):
    """Exact (erf) GELU by default, as GPT uses it; tanh form on request."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
