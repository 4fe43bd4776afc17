"""The op library and the Tensor methods (counterpart:
``paddle_tpu/ops/__init__.py``).

The math, manipulation, statistics and random ops are module functions
that take and return ``Tensor``s; :func:`_patch_tensor` attaches them to
``Tensor`` as its methods, as the reference's ``_patch_tensor`` does, so
``x.sum(axis=0)``, ``x.reshape([2, 3])`` and ``x[idx]`` keep the
reference's meaning. ``Parameter`` gets only the names torch does not
define (``core.tensor``'s docstring). The models of the port call the
same bodies without the boundary (:data:`plain`): plain tensors in and
out, so a model's inside never meets ``Tensor``.

Under an op observer (``core.dispatch``) each op is one op under its
reference name; ``call_op``/``call_op_nograd`` run any function that way.

``sequence`` holds the LoD sequence ops and the decoding tail
(``gather_tree``, ``edit_distance``, ``ctc_align``), under
``ops.sequence`` as in the reference; ``ctr_tail`` the CTR, text-matching
and tree op tail and ``tdm`` the TDM sampler and child ops, re-exported
here as in the reference; ``misc_tail`` the residual op tail (metrics,
linear-algebra composites, sharding helpers, vision IO), re-exported here
and at the top level as in the reference.
"""
import types

import torch

from ..core.dispatch import call_op, call_op_nograd  # noqa: F401
from ..core.dtype import convert_dtype  # noqa: F401
from ..core.tensor import Parameter, Tensor, unwrap
from . import (ctr_tail, extras, manipulation, math, misc_tail,  # noqa: F401
               random, sequence, tdm)
from .ctr_tail import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .misc_tail import *  # noqa: F401,F403
from .random import (bernoulli, multinomial, normal, rand, randint,  # noqa: F401
                     randn, randperm, shuffle, truncated_normal, uniform)
from .tdm import tdm_child, tdm_sampler  # noqa: F401

__all__ = (["Tensor"] + math.__all__ + manipulation.__all__ + extras.__all__
           + random.__all__ + ctr_tail.__all__ + tdm.__all__
           + misc_tail.__all__)

# the ops' bodies over plain tensors, as the models call them
plain = types.SimpleNamespace(**{
    f.__name__: f.__wrapped__ for f in (
        manipulation.reshape, manipulation.flatten, manipulation.unstack,
        math.arange, math.matmul, math.cast)})

MATH_METHODS = [
    "exp", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "square",
    "abs", "sign", "reciprocal", "floor", "ceil", "round", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "erf", "clip",
    "add", "subtract", "multiply", "divide", "mod", "pow", "maximum",
    "minimum", "sum", "mean", "max", "min", "prod", "std", "var",
    "logsumexp", "all", "any", "argmax", "argmin", "argsort", "sort",
    "topk", "cumsum", "cumprod", "matmul", "dot", "bmm", "mm", "norm",
    "cast", "isnan", "isinf", "isfinite", "allclose", "equal_all"]
MANIPULATION_METHODS = [
    "reshape", "flatten", "transpose", "squeeze", "unsqueeze", "tile",
    "expand", "expand_as", "broadcast_to", "flip", "roll", "gather",
    "gather_nd", "split", "chunk", "unstack", "slice", "strided_slice",
    "index_select", "masked_select", "masked_fill", "unique", "numel",
    "take_along_axis", "put_along_axis", "repeat_interleave", "moveaxis"]
EXTRAS_METHODS = [
    "median", "kthvalue", "mode", "quantile", "nanmedian", "histogram",
    "bincount", "unique_consecutive", "diff", "trace", "kron", "outer",
    "cross", "diagonal", "rot90", "lerp", "trunc", "frac", "nanmean",
    "nansum", "deg2rad", "rad2deg", "gcd", "lcm", "heaviside", "digamma",
    "lgamma", "conj", "real", "imag", "mv", "dist", "increment", "unbind"]


def _make_method(fn):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = method.__qualname__ = fn.__name__
    method.__doc__ = fn.__doc__
    return method


def _make_inplace(fn):
    """``fn``'s result written into the tensor itself (torch's in-place
    rules: a leaf that requires grad refuses it outside ``no_grad``)."""
    def method(self, *args, **kwargs):
        out = unwrap(fn(self, *args, **kwargs))
        with torch._C.DisableTorchFunctionSubclass():
            torch.Tensor.copy_(self, out)
        return self
    method.__name__ = method.__qualname__ = fn.__name__ + "_"
    return method


def _zero(self):
    return _fill(self, 0)


def _fill(self, v):
    with torch._C.DisableTorchFunctionSubclass():
        torch.Tensor.fill_(self, unwrap(v))
    return self


def _patch_tensor():
    T = Tensor
    for module, names in ((math, MATH_METHODS),
                          (manipulation, MANIPULATION_METHODS),
                          (extras, EXTRAS_METHODS)):
        for name in names:
            method = _make_method(getattr(module, name))
            setattr(T, name, method)
            if not hasattr(torch.Tensor, name):
                setattr(Parameter, name, method)
    T.__getitem__ = lambda self, idx: manipulation.getitem(self, idx)
    T.__setitem__ = lambda self, idx, v: manipulation.setitem(self, idx, v)
    T.__invert__ = lambda self: math.logical_not(self)
    T.T = property(lambda self: math.t(self))
    T.t = lambda self: math.t(self)
    for cls in (T, Parameter):
        cls.astype = lambda self, dtype: math.cast(self, dtype)
        cls.scale = (lambda self, scale=1.0, bias=0.0:
                     math.scale(self, scale, bias))
        cls.scale_ = _make_inplace(math.scale)
    T.add_ = _make_inplace(math.add)
    T.subtract_ = _make_inplace(math.subtract)
    T.multiply_ = _make_inplace(math.multiply)
    T.clip_ = _make_inplace(math.clip)
    T.zero_ = _zero
    T.fill_ = _fill


_patch_tensor()
