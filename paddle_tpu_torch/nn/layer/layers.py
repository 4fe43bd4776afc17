"""Layer: the module base class, and ParamAttr (counterpart:
``paddle_tpu/nn/layer/layers.py``).

A ``torch.nn.Module`` that keeps the reference's surface: ``ParamAttr``
and ``create_parameter(shape, attr=...)`` (the attribute's initializer,
name, ``trainable``, and the ``learning_rate``, ``regularizer`` and
``need_clip`` that the optimizers read from the parameter) through the
package's initializers on an explicit device, as a ``Parameter``
(``core.tensor``); a call with ``Tensor`` inputs hands ``forward`` plain
tensors and returns ``Tensor``s (``core.tensor.boundary``), a call with
plain tensors runs as ``torch.nn.Module``'s; ``parameters()`` and
``named_parameters()`` returning lists, with ``include_sublayers``;
``state_dict(include_sublayers, structured_name_prefix)``;
``set_state_dict`` returning (missing, unexpected); ``to(dtype)`` taking
paddle dtype names; ``enable_recompute``/``disable_recompute`` (the
reference's recompute seam). ``parameters()`` names each parameter as
``p.param_name`` (its ``ParamAttr`` name, else its structured name under
the layer): the optimizers key their state by it (torch reserves
``Tensor.name``). torch's own keywords stay: ``recurse=`` and
``remove_duplicate=``, ``state_dict``'s ``destination=``, ``prefix=`` and
``keep_vars=``, ``register_buffer``'s ``persistent=``. Structured
``state_dict`` names match the reference's (``gpt.blocks.0.qkv.weight``).
"""
import types
from collections import OrderedDict

import numpy as np
import torch

from ...core.dtype import convert_dtype, is_dtype_name
from ...core.tensor import Parameter, boundary, clear_grads
from ...observability import memory as _memory
from .. import initializer as I


class ParamAttr:
    """The attributes of a parameter: ``name``, ``initializer``,
    ``learning_rate`` (a factor on the optimizer's rate), ``regularizer``
    (over the optimizer's ``weight_decay``), ``trainable`` and
    ``need_clip``."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """``None``, a ``ParamAttr``, an initializer or a name as a
        ``ParamAttr``; ``False`` (no parameter) stays ``False``."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        raise TypeError(f"bad ParamAttr: {attr!r}")


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        _memory.register_layer(self)  # its buffers, for the state ledger
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        """A parameter of ``shape`` drawn on ``device`` by ``attr``'s
        initializer, else ``default_initializer``, else Xavier (a zero
        bias); None for ``attr=False``."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = (attr.initializer or default_initializer
                or (I.Constant(0.0) if is_bias else I.XavierNormal()))
        value = init(shape, dtype or self._dtype, device=device)
        p = Parameter(value, trainable=attr.trainable)
        if attr.name is not None:
            p.param_name = p._attr_name = attr.name
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    __call__ = boundary(torch.nn.Module.__call__)

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        """[(structured name, parameter)]; ``recurse`` is torch's name for
        ``include_sublayers``."""
        recurse = include_sublayers if recurse is None else recurse
        return list(super().named_parameters(
            prefix=prefix, recurse=recurse,
            remove_duplicate=remove_duplicate))

    def parameters(self, include_sublayers=True, recurse=None):
        """The parameters as a list; each gets ``p.param_name``, its
        ``ParamAttr`` name, else its structured name under this layer."""
        out = []
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers, recurse=recurse):
            p.param_name = getattr(p, "_attr_name", None) or name
            out.append(p)
        return out

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """A buffer, in ``state_dict`` when ``persistable`` (torch's
        ``persistent``)."""
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def state_dict(self, include_sublayers=True, structured_name_prefix="",
                   destination=None, prefix=None, keep_vars=False):
        """The parameters and persistable buffers by structured name,
        each under ``structured_name_prefix`` (joined by a dot, as the
        reference names them), this layer's own only without
        ``include_sublayers``."""
        if prefix is None:
            prefix = (structured_name_prefix + "."
                      if structured_name_prefix else "")
        if include_sublayers:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        out = OrderedDict() if destination is None else destination
        for name, t in self._parameters.items():
            if t is not None:
                out[prefix + name] = t if keep_vars else t.detach()
        for name, t in self._buffers.items():
            if t is not None and name not in self._non_persistent_buffers_set:
                out[prefix + name] = t if keep_vars else t.detach()
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy matching entries in place (cast to each parameter's dtype
        and device); returns the reference's (missing, unexpected) lists.
        ``use_structured_name=False`` keys the parameters by
        ``param_name`` (their ``ParamAttr`` names) instead."""
        own = self.state_dict(keep_vars=True)
        if not use_structured_name:
            self.parameters()  # stamps param_name
            own = OrderedDict((getattr(t, "param_name", n), t)
                              for n, t in own.items())
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
        clear_grads(self.parameters())

    def astype(self, dtype):
        return self.to(dtype)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after every forward; a result
        that is not None replaces the outputs."""
        return self.register_forward_hook(hook)

    def full_name(self):
        return self._name_scope

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
