"""PyLayer and the functional gradient (counterpart:
``paddle_tpu/autograd``)."""
from ..core.autograd import backward, enable_grad, grad, no_grad  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401
