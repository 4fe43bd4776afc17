"""Sequential, LayerList, LayerDict and ParameterList (counterpart:
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


class LayerDict(Layer):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        """Add ``(name, layer)`` pairs from a dict or a list of pairs."""
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)


class ParameterList(Layer):
    """Parameters named ``"0"``, ``"1"``, ... as in the reference."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        if not isinstance(parameter, torch.nn.Parameter):
            raise TypeError(f"ParameterList holds Parameters, not "
                            f"{type(parameter).__name__}")
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
