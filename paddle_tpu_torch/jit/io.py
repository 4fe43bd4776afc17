"""jit.save / jit.load: inference model export (counterpart:
``paddle_tpu/jit/io.py``).

Two artifacts are written:

- with ``input_spec``: the process-independent ``.pdmodel`` +
  ``.pdiparams`` pair (``export.py``), which ``inference.Predictor``,
  ``serving.Engine`` and :func:`load` serve with no access to the model's
  class;
- always: a state_dict archive and a best-effort pickle of the layer
  (``.pdiparams.npz`` + ``.pdlayer``) for same-codebase reload.

:func:`load` takes the exported artifact first, then the pickle.
"""
import os
import pickle
import warnings

import numpy as np
import torch

from .export import (_from_npz_array, _to_npz_array, has_artifact,
                     save_exported, ServedProgram)

__all__ = ["save", "load", "TranslatedLayer", "ServedLayer"]

_SUFFIX_PARAMS = ".pdiparams"
_SUFFIX_MODEL = ".pdmodel"
_SUFFIX_LAYER = ".pdlayer"


def _save_state_dict_np(state_dict, path):
    # np.savez keys cannot hold '/': positional keys and a name list
    np.savez(path, **{f"t{i}": _to_npz_array(v)
                      for i, v in enumerate(state_dict.values())})
    return list(state_dict), [str(v.dtype).replace("torch.", "")
                              for v in state_dict.values()]


def save(layer, path, input_spec=None, **config):
    """Save the layer's parameters and the layer for :func:`load`; with
    ``input_spec`` (``InputSpec`` s, ``(shape, dtype[, name])`` tuples or
    example tensors) also export its eval forward to the
    process-independent ``.pdmodel`` + ``.pdiparams`` pair (the batch axis
    bounded to ``export.BATCH_MAX``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = layer.state_dict()
    names, dtypes = _save_state_dict_np(sd, path + _SUFFIX_PARAMS + ".npz")
    meta = {"names": names, "dtypes": dtypes,
            "class_module": type(layer).__module__,
            "class_name": type(layer).__qualname__, "input_spec": None}
    # best effort: a layer defined inside a function does not pickle
    try:
        blob = pickle.dumps({"meta": meta, "layer": layer})
    except Exception:  # noqa: BLE001 -- recorded as an unpicklable layer
        blob = pickle.dumps({"meta": meta, "layer": None})
    with open(path + _SUFFIX_LAYER, "wb") as f:
        f.write(blob)

    specs = input_spec if input_spec is not None else config.get(
        "example_inputs")
    if specs is None:
        warnings.warn(
            "jit.save without input_spec writes only the same-codebase "
            "reload artifact; pass input_spec to export a "
            "process-independent .pdmodel for serving")
        return
    # per-sublayer save/restore: a blanket layer.train() would clobber
    # mixed modes (a frozen .eval() backbone inside a training model)
    modes = [(l, l.training)
             for _, l in layer.named_sublayers(include_self=True)]
    layer.eval()
    try:
        state = dict(layer.named_parameters())
        state.update(layer.named_buffers())
        save_exported(path, layer, list(state.items()), list(specs))
    finally:
        for l, m in modes:
            l.training = m


class TranslatedLayer:
    """A layer reloaded from the same-codebase pickle (reference:
    ``TranslatedLayer``), called in eval mode without gradients."""

    def __init__(self, layer):
        self._layer = layer
        self._layer.eval()

    def __call__(self, *args, **kwargs):
        with torch.no_grad():
            return self._layer(*args, **kwargs)

    def eval(self):
        self._layer.eval()
        return self

    def state_dict(self):
        return self._layer.state_dict()


class ServedLayer:
    """A loaded exported artifact, callable like the original model with
    no model class needed (reference: the ``TranslatedLayer`` loaded from
    ``__model__``). Returns tensors on the artifact's device."""

    def __init__(self, served):
        self._served = served

    def __call__(self, *args):
        outs = self._served(*args)
        return outs[0] if len(outs) == 1 else tuple(outs)

    forward = __call__

    def eval(self):
        return self

    def state_dict(self):
        return self._served.state_dict()

    @property
    def input_names(self):
        return self._served.input_names

    @property
    def output_names(self):
        return self._served.output_names


def load(path, device=None, **config):
    """The exported artifact at ``path`` as a :class:`ServedLayer` on
    ``device`` (default ``cuda``), else the pickled layer as a
    :class:`TranslatedLayer`. A reference (StableHLO) artifact raises
    ``export.ForeignArtifactError``."""
    if has_artifact(path):
        return ServedLayer(ServedProgram(path, device=device))
    with open(path + _SUFFIX_LAYER, "rb") as f:
        blob = pickle.load(f)
    layer = blob["layer"]
    if layer is None:
        raise RuntimeError(
            f"{path}: the layer's class could not be pickled at save time; "
            "rebuild the layer and load its state_dict, or re-save with "
            "input_spec for a class-free artifact")
    data = np.load(path + _SUFFIX_PARAMS + ".npz")
    meta = blob["meta"]
    layer.set_state_dict({name: _from_npz_array(data[f"t{i}"], dt)
                          for i, (name, dt) in enumerate(
                              zip(meta["names"], meta["dtypes"]))})
    return TranslatedLayer(layer)
