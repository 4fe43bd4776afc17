"""Pipeline layer descriptions (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``).

``PipelineLayer`` segments a list of ``LayerDesc``\\ s (or layers, or plain
callables) into stages with the reference's rules (``uniform``,
``param_size``, ``layer:ClassName``) and builds only this rank's stage:
``stage_id`` (default: this rank's pipe coordinate in the fleet topology).
Its layers keep the reference's names (``layers.<j>``, j a layer's
position among all the built layers of every stage), so its state_dict
names are the reference's for the layers it holds. ``param_size``
segmentation counts each item's parameters on a CPU build whose draws are
undone (the package's generators are restored), so it costs no weights.

A ``SharedLayerDesc`` item (one key, used on several stages, such as tied
embeddings) is built on every stage that uses it, under the name of its
first item; ``PipelineParallel`` makes the copies equal at wrap time (from
the first stage that uses it) and sums their gradients over those stages.
"""
import inspect

import torch

from ....core import random as core_random
from ....nn.layer.layers import Layer


def _accepts_device(cls):
    try:
        return "device" in inspect.signature(cls.__init__).parameters
    except (TypeError, ValueError):
        return False


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_cls, torch.nn.Module):
            raise TypeError("layer_cls must be a Layer subclass")

    def build_layer(self, device=None):
        kwargs = dict(self.kwargs)
        if device is not None and _accepts_device(self.layer_cls):
            kwargs.setdefault("device", device)
        return self.layer_cls(*self.inputs, **kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _n_params(item):
    """Parameter count of one run-list item (0 for a callable)."""
    if isinstance(item, torch.nn.Module):
        return sum(p.numel() for p in item.parameters())
    if not isinstance(item, LayerDesc):
        return 0
    saved = core_random.capture_state()
    try:
        layer = item.build_layer(device="cpu")
        return sum(p.numel() for p in layer.parameters())
    finally:
        core_random.restore_state(saved)


def segment(items, num_stages, seg_method="uniform"):
    """Stage boundaries ``[0, b1, ..., n]`` of ``items`` (the reference's
    ``_segment_network``)."""
    n, k = len(items), num_stages
    if seg_method == "uniform":
        base, rem = divmod(n, k)
        bounds = [0]
        for i in range(k):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return bounds
    if seg_method == "param_size":
        prefix = [0]
        for item in items:
            prefix.append(prefix[-1] + _n_params(item))
        total = max(prefix[-1], 1)
        bounds = [0]
        for i in range(1, k):
            target = total * i / k
            j = bounds[-1] + 1
            hi = n - (k - i)  # at least one item per remaining stage
            while j < hi and prefix[j] < target:
                j += 1
            bounds.append(min(max(j, bounds[-1] + 1), hi))
        bounds.append(n)
        return bounds
    if not seg_method.startswith("layer:"):
        raise ValueError(
            f"unknown seg_method {seg_method!r}: expected 'uniform', "
            "'param_size', or 'layer:ClassName'")
    cls_name = seg_method.split(":")[1]

    def name_of(item):
        if isinstance(item, LayerDesc):
            return item.layer_cls.__name__
        return type(item).__name__ if isinstance(item, torch.nn.Module) \
            else None

    marks = [i for i, item in enumerate(items) if name_of(item) == cls_name]
    per = max(len(marks) // k, 1)
    bounds = [0]
    for i in range(1, k):
        idx = i * per
        bounds.append(marks[idx] if idx < len(marks) else n)
    bounds.append(n)
    return bounds


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 stage_id=None, device=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        self._recompute_interval = recompute_interval
        self.descs = list(layers)
        for d in self.descs:
            if not (isinstance(d, (LayerDesc, torch.nn.Module))
                    or callable(d)):
                raise TypeError(f"bad pipeline item: {d!r}")
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        if stage_id is None:
            from ..base.topology import get_hybrid_communicate_group
            hcg = get_hybrid_communicate_group()
            stage_id = hcg.get_stage_id() if (
                hcg is not None and self._num_stages > 1) else 0
        self.stage_id = int(stage_id)
        self._segments = segment(self.descs, self._num_stages, seg_method)
        lo, hi = self._segments[self.stage_id], self._segments[
            self.stage_id + 1]
        # the reference names the built layers by their position among
        # the built ones (callables and repeated shared keys build none)
        self.layers = torch.nn.ModuleDict()
        self.run_list = []
        self._shared_map = {}
        self.shared_keys = {}  # key -> the stages that use it
        seen, j = set(), 0
        for i, d in enumerate(self.descs):
            index = None
            if isinstance(d, SharedLayerDesc):
                self.shared_keys.setdefault(d.layer_name, set()).add(
                    self.get_stage_from_index(i))
                if d.layer_name not in seen:
                    seen.add(d.layer_name)
                    index, j = j, j + 1
            elif isinstance(d, (LayerDesc, torch.nn.Module)):
                index, j = j, j + 1
            if not lo <= i < hi:
                continue
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared_map:
                    layer = d.build_layer(device)
                    self._shared_map[d.layer_name] = layer
                    self.layers[str(index if index is not None else
                                    self._first_index(d.layer_name))] = layer
                self.run_list.append(("shared", d))
            elif isinstance(d, LayerDesc):
                self.layers[str(index)] = layer = d.build_layer(device)
                self.run_list.append(("layer", layer))
            elif isinstance(d, torch.nn.Module):
                self.layers[str(index)] = d
                self.run_list.append(("layer", d))
            else:
                self.run_list.append(("func", d))
        self._n_built = j

    def _first_index(self, key):
        """The built-layer index of a shared key's first item."""
        j = 0
        seen = set()
        for d in self.descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name == key:
                    return j
                if d.layer_name not in seen:
                    seen.add(d.layer_name)
                    j += 1
            elif isinstance(d, (LayerDesc, torch.nn.Module)):
                j += 1
        raise KeyError(key)

    @property
    def num_stages(self):
        return self._num_stages

    def get_stage_from_index(self, index):
        return next(s for s in range(self._num_stages)
                    if self._segments[s] <= index < self._segments[s + 1])

    def other_stage(self, name):
        """Whether a reference state name (``layers.<j>.…``) is a layer of
        another stage."""
        parts = name.split(".")
        return (len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit()
                and int(parts[1]) < self._n_built
                and parts[1] not in self.layers)

    def forward(self, x):
        for kind, item in self.run_list:
            if kind == "shared":
                layer = self._shared_map[item.layer_name]
                x = item.forward_func(layer, x) if item.forward_func \
                    else layer(x)
            else:
                x = item(x)
        return x
