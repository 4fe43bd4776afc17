"""Sequential and LayerList (counterpart:
``paddle_tpu/nn/layer/container.py``)."""
import torch

from .layers import Layer


class Sequential(Layer):
    """Calls its sublayers in order. Sublayers are named ``"0"``, ``"1"``,
    ... as in the reference, or by the names of ``(name, layer)`` pairs
    given one by one or as one list."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer, torch.nn.ModuleList):
    """Sublayers named ``"0"``, ``"1"``, ... as in the reference."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        for layer in sublayers or ():
            self.append(layer)

    # the reference's argument names for torch.nn.ModuleList's own
    def append(self, layer):
        return torch.nn.ModuleList.append(self, layer)

    def insert(self, index, layer):
        return torch.nn.ModuleList.insert(self, index, layer)

    def extend(self, layers):
        return torch.nn.ModuleList.extend(self, layers)
