"""ReLU (counterpart: ``paddle_tpu/nn/layer/activation.py``)."""
from .. import functional as F
from .layers import Layer


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)
