"""LayerList (counterpart: ``paddle_tpu/nn/layer/container.py``)."""
import torch

from .layers import Layer


class LayerList(Layer, torch.nn.ModuleList):
    """Sublayers named ``"0"``, ``"1"``, ... as in the reference."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        for layer in sublayers or ():
            self.append(layer)
