"""``paddle.save`` / ``paddle.load`` (counterpart:
``paddle_tpu/serialization.py``).

The container is the reference's: a pickle of the object in which every
tensor is a ``{"__paddle_tpu_tensor__": True, "data": numpy array,
"stop_gradient": bool, "name": str}`` record, so a file saved by either
package loads in the other. bfloat16 data is ``ml_dtypes.bfloat16`` where
that package is installed, as the reference writes it; elsewhere it is
widened to float32 (exact) and the record adds ``"dtype": "bfloat16"``,
which this loader honours.
"""
import os
import pickle

import numpy as np
import torch

from .checkpoint.state import from_numpy, to_numpy
from .core.device import resolve_device

__all__ = ["save", "load"]


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        data = to_numpy(obj)
        rec = {"__paddle_tpu_tensor__": True, "data": data,
               "stop_gradient": not obj.requires_grad,
               "name": getattr(obj, "param_name", None) or "tensor"}
        if obj.dtype == torch.bfloat16 and data.dtype != obj.dtype:
            rec["dtype"] = "bfloat16"
        return rec
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj, return_numpy, device):
    if isinstance(obj, dict):
        if obj.get("__paddle_tpu_tensor__"):
            if return_numpy:
                return obj["data"]
            t = from_numpy(np.array(obj["data"], copy=True)).to(device)
            if obj.get("dtype") == "bfloat16":
                t = t.to(torch.bfloat16)
            if not obj.get("stop_gradient", True) and t.is_floating_point():
                t.requires_grad_(True)
            return t
        return {k: _from_saveable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy, device)
                         for v in obj)
    return obj


def save(obj, path, protocol=4):
    """Pickle ``obj`` (tensors as the reference's records) to ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **config):
    """Load what :func:`save` (or the reference's ``save``) wrote. Tensors
    come back on the card unless ``place="cpu"`` (or ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    device = None if return_numpy else resolve_device(config.get("place"))
    return _from_saveable(obj, return_numpy, device)
