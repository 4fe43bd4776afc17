"""Layer: the module base class (counterpart:
``paddle_tpu/nn/layer/layers.py``).

A ``torch.nn.Module`` that keeps the reference's surface where the port
needs it: ``create_parameter`` through the package's initializers on an
explicit device, ``set_state_dict`` returning (missing, unexpected),
``to(dtype)`` taking paddle dtype names, and ``parameters()`` naming
each parameter by its structured name as ``p.param_name`` (what the
optimizers key their state by; torch reserves ``Tensor.name``).
Structured ``state_dict`` names are ``torch.nn.Module``'s own and match
the reference's (``gpt.blocks.0.qkv.weight``, ...).
"""
import numpy as np
import torch

from ...core.dtype import convert_dtype, is_dtype_name
from .. import initializer as I


class Layer(torch.nn.Module):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def create_parameter(self, shape, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        init = default_initializer or (I.Constant(0.0) if is_bias
                                       else I.XavierNormal())
        value = init(shape, dtype or self._dtype, device=device)
        return torch.nn.Parameter(value)

    def parameters(self, recurse=True):
        """``torch.nn.Module.parameters``, and each parameter gets
        ``p.param_name``, its structured name under this layer (the
        reference names parameters too)."""
        for name, p in self.named_parameters(recurse=recurse):
            p.param_name = name
            yield p

    def set_state_dict(self, state_dict):
        """Copy matching entries in place (cast to each parameter's dtype
        and device); returns the reference's (missing, unexpected)
        lists."""
        own = self.state_dict(keep_vars=True)
        missing = []
        with torch.no_grad():
            for name, t in own.items():
                if name in state_dict:
                    v = state_dict[name]
                    if not isinstance(v, torch.Tensor):
                        v = torch.from_numpy(np.array(v, copy=True))
                    t.copy_(v)
                else:
                    missing.append(name)
        unexpected = [n for n in state_dict if n not in own]
        return missing, unexpected

    def to(self, *args, **kwargs):
        """``torch.nn.Module.to`` that also takes paddle dtype names
        (``layer.to("bfloat16")``)."""
        args = tuple(convert_dtype(a) if is_dtype_name(a) else a
                     for a in args)
        if is_dtype_name(kwargs.get("dtype")):
            kwargs["dtype"] = convert_dtype(kwargs["dtype"])
        return super().to(*args, **kwargs)
