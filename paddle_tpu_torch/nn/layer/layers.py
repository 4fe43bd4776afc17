"""Layer: the module base class (counterpart:
``paddle_tpu/nn/layer/layers.py``).

A ``torch.nn.Module`` that keeps the reference's surface where the port
needs it: ``create_parameter`` through the package's initializers on an
explicit device, ``set_state_dict`` returning (missing, unexpected),
``to(dtype)`` taking paddle dtype names, and ``parameters()`` naming
each parameter by its structured name as ``p.param_name`` (what the
optimizers key their state by; torch reserves ``Tensor.name``), and
``enable_recompute``/``disable_recompute`` (the reference's recompute seam).
Structured ``state_dict`` names are ``torch.nn.Module``'s own and match
the reference's (``gpt.blocks.0.qkv.weight``, ...).
"""
import types

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

    # -- the reference's names for torch.nn.Module's own --------------------
    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        """(structured name, layer) of every sublayer, each once."""
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def astype(self, dtype):
        return self.to(dtype)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after every forward; a result
        that is not None replaces the outputs."""
        return self.register_forward_hook(hook)

    def full_name(self):
        return type(self).__name__.lower()

    load_dict = set_state_dict

    # -- recompute seam ---------------------------------------------------
    def enable_recompute(self, policy="full"):
        """Run this layer's forward as a recompute segment
        (``paddle_tpu_torch.recompute``) with ``policy`` (``full``,
        ``selective``, ``offload`` or a predicate over aten ops), in
        training mode with gradients enabled; otherwise the forward runs
        plainly. Forward hooks run outside the segment, once a call.
        Returns ``self``."""
        from ...recompute import resolve_policy
        if not callable(policy):
            resolve_policy(policy, device="cuda")  # check the name now
        self._recompute_policy = policy
        # torch.nn.Module's call path runs ``self.forward`` between the
        # hooks: an instance attribute routes it through the segment
        self.forward = types.MethodType(_recompute_forward, self)
        return self

    def disable_recompute(self):
        self.__dict__.pop("forward", None)
        self._recompute_policy = None
        return self


def _recompute_forward(self, *inputs, **kwargs):
    forward = type(self).forward.__get__(self)
    if self.training and torch.is_grad_enabled():
        from ...recompute import _segment_call
        return _segment_call(forward, inputs, kwargs, self._recompute_policy)
    return forward(*inputs, **kwargs)
