"""Tensor and Parameter, the reference's imperative tensor types over torch
(counterpart: ``paddle_tpu/core/tensor.py``).

How they meet torch (the design this package states):

- ``Tensor`` subclasses ``torch.Tensor`` and takes the reference's meaning
  for every name of its surface (``shape`` a list, ``size`` an int,
  ``sum(axis=)``, ``max`` returning values, ``transpose(perm)``, ...).
  ``to_tensor`` and the ``ops`` functions return it, and its
  ``__torch_function__`` keeps torch's results as ``Tensor``; a torch
  function written in Python (``torch.nn.functional``, ``Tensor.split``)
  receives plain tensors, so torch's own code never meets the reference's
  meanings.
- ``Parameter`` subclasses ``torch.nn.Parameter``, which disables
  ``__torch_function__``: a parameter adds no per-op cost, and every name
  that ``torch.Tensor`` defines keeps torch's meaning on it (torch's own
  code and the port's layers call ``p.size()``, ``p.shape``,
  ``p.transpose(0, 1)``, ...). The names torch does not define
  (``stop_gradient``, ``trainable``, ``set_value``, ``clear_grad``,
  ``scale``, ``unstack``, ...) carry the reference's meaning.
  ``isinstance(p, Tensor)`` holds, as in the reference.
- A ``Layer`` call, a functional of ``nn.functional`` and a model's
  ``loss`` take ``Tensor`` inputs at their boundary (:func:`boundary`):
  they hand their body plain tensors (``as_subclass(torch.Tensor)``, a
  view that keeps autograd) and return ``Tensor``s. A call with plain
  tensors is passed through untouched, so a model's inside, its CUDA
  graphs and its ``torch.export`` programs run exactly as without this
  module.

Deliberate differences of ``Tensor`` from the reference (each tested in
``tests/test_torch_tensor.py``):

- ``dtype`` is a ``torch.dtype`` (the package's dtype names are torch's:
  ``paddle_tpu_torch.float32 is torch.float32``); ``place`` is the
  ``torch.device``.
- ``numpy()`` of a bfloat16 tensor is float32 (numpy has no bfloat16
  here); the widening is exact.
- ``stop_gradient = True`` on a tensor that is not a leaf raises (torch
  cannot stop a recorded graph in place): use ``detach()``.
- The in-place methods (``add_``, ``scale_``, ...) on a leaf that needs
  its gradient raise, as torch's do; the reference rebinds the value.
- ``to_tensor`` keeps numpy's dtype, 64 bits included, and makes Python
  floats float32 and Python ints int64 (paddle's defaults); the
  reference, jax without 64-bit types, narrows 64-bit data to 32 bits.

Deliberate differences of ``Parameter`` (torch's meaning kept): ``shape``
(a ``torch.Size``), ``size`` (a method), ``name`` (torch's; the
package's name is ``param_name``), ``grad`` (torch's tensor), ``numel``
(an int), ``allclose`` (a bool), ``split`` (by section size),
``transpose`` (two axes), ``t`` (at most 2-d), ``unsqueeze`` (one
axis), ``squeeze`` (torch's ``dim``), ``max``/``min``/``median``/``nanmedian``/``mode``/``kthvalue``
with an axis (values and indices), ``sort`` (values and indices),
``gather``/``index_select`` (the axis first), ``unique`` and
``unique_consecutive`` (torch's keywords), ``cumsum``/``logsumexp`` (an
axis required), ``histogram`` (counts and edges), ``real``/``imag``
(properties), ``numpy`` (raises while it requires grad), ``norm``,
``backward``, ``flatten``/``reshape``/``expand`` (torch's argument
forms) and every other torch method, with torch's keywords (``dim=``).

The sparse (row) gradient of a parameter looked up by
``embedding(sparse=True)`` rides on the parameter as a ``SelectedRows``
(``p._sparse_grad``), as the reference's ``p._grad`` carries it;
``p.grad`` stays what torch makes it. Two sparse gradients merge; a sparse
and a dense one make a dense one (:func:`grad_of`), the reference's
accumulation rules (``paddle_tpu/core/tensor.py:112-129``).
"""
import copy
import functools
import types

import numpy as np
import torch

from . import dispatch, state
from .device import resolve_device
from .dtype import convert_dtype

__all__ = ["Tensor", "Parameter", "to_tensor", "boundary", "unwrap",
           "wrap", "host_array", "grad_of", "accumulate_sparse",
           "fold_sparse", "clear_grads"]

_TensorBase = torch._C.TensorBase


def _is_python(func):
    f = getattr(func, "__func__", func)
    return isinstance(f, types.FunctionType)


def unwrap(x):
    """A ``Tensor`` (in a nest of tuples, lists and dicts) as a plain
    torch tensor: an alias that keeps autograd; anything else as given."""
    t = type(x)
    if t is Tensor:
        out = x.as_subclass(torch.Tensor)
        if dispatch._RECORDING[0]:
            _alias(x, out)
        return out
    if t is tuple or t is list:
        return t(unwrap(v) for v in x)
    if t is dict:
        return {k: unwrap(v) for k, v in x.items()}
    return x


def wrap(x):
    """Plain torch tensors (in a nest of tuples, lists and dicts) as
    ``Tensor``s; parameters and anything else as given."""
    t = type(x)
    if t is torch.Tensor:
        out = x.as_subclass(Tensor)
        if dispatch._RECORDING[0]:
            _alias(x, out)
        return out
    if t is tuple or t is list:
        return t(wrap(v) for v in x)
    if isinstance(x, tuple) and t.__module__ == "torch.return_types":
        return t([wrap(v) for v in x])
    if t is dict:
        return {k: wrap(v) for k, v in x.items()}
    return x


def _alias(x, out):
    """A recorded Program reads ``out`` (a new Python object over the same
    tensor) as the variable ``x`` is."""
    for prog in dispatch._rec.stack:
        prog._alias(x, out)


def _has_tensor(args, kwargs):
    for a in args:
        t = type(a)
        if t is Tensor:
            return True
        if (t is list or t is tuple) and any(type(v) is Tensor for v in a):
            return True
    for a in kwargs.values():
        if type(a) is Tensor:
            return True
    return False


def boundary(fn, always=False, op_name=None):
    """The reference's boundary for a function written over plain torch
    tensors: called with a ``Tensor`` it gets plain tensors and its tensor
    results come back as ``Tensor``s; called with none it runs as is,
    unless ``always`` (the ``ops``) asks for ``Tensor`` results anyway.
    With ``op_name`` (the ops and the functionals), a call that crosses
    the boundary runs under the op observers as that one op
    (``core.dispatch``), and under ``static.program_guard`` any call that
    reads a program variable or a parameter is recorded as that one op.
    The body stays reachable as ``__wrapped__``."""
    name = op_name

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if name is not None and dispatch._RECORDING[0]:
            prog = dispatch.recorder()
            if prog is not None:  # one op of a static Program
                out = prog._record(fn, args, kwargs, name, plain_body=True)
                if out is not prog.NOT_RECORDED:
                    return out
        if not always and not _has_tensor(args, kwargs):
            return fn(*args, **kwargs)
        if op_name is not None and dispatch._OBSERVER_LIST is not None:
            return dispatch.call_op(fn, *args, op_name=op_name, **kwargs)
        return wrap(fn(*unwrap(args), **unwrap(kwargs)))
    return call


def _as_torch(data, dtype=None, device=None):
    """``data`` as a plain torch tensor: a tensor stays on its device (or
    moves to ``device``), host data goes to ``device`` (the card unless
    it says the CPU)."""
    dtype = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = unwrap(data).detach()
        if device is not None:
            t = t.to(resolve_device(device))
    else:
        arr = np.array(data, copy=True)
        if arr.dtype == np.float64 and not isinstance(
                data, (np.ndarray, np.generic)):
            arr = arr.astype(np.float32)  # Python floats: paddle's default
        t = torch.from_numpy(arr).to(resolve_device(device))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t


_NAMES = {torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
          torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.float32: "float32", torch.float64: "float64"}


def host_array(t):
    """A detached host copy as numpy (bfloat16 widened to float32)."""
    t = unwrap(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Meta(type(torch.Tensor)):
    def __instancecheck__(cls, obj):
        return type.__instancecheck__(cls, obj) or (
            cls is Tensor and type.__instancecheck__(Parameter, obj))


class Tensor(torch.Tensor, metaclass=_Meta):
    """The reference's ``Tensor``: ``Tensor(data, dtype, stop_gradient,
    name)`` makes a leaf from ``data`` (a tensor on its device, host data
    on the card)."""

    def __new__(cls, data, dtype=None, stop_gradient=True, name=None):
        t = torch.Tensor._make_subclass(cls, _as_torch(data, dtype),
                                        not stop_gradient)
        if name is not None:
            t._name = name
        return t

    def __init__(self, data, dtype=None, stop_gradient=True, name=None):
        pass  # made in __new__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if kwargs is None:
            kwargs = {}
        if _is_python(func):  # torch's own Python code sees plain tensors
            args, kwargs = unwrap(args), unwrap(kwargs)
        with torch._C.DisableTorchFunctionSubclass():
            ret = func(*args, **kwargs)
        if func in _NOWRAP:
            return ret
        return wrap(ret)

    # -- metadata -------------------------------------------------------
    @property
    def shape(self):
        return list(_TensorBase.shape.__get__(self))

    @property
    def size(self):
        return _TensorBase.numel(self)

    @property
    def place(self):
        return _TensorBase.device.__get__(self)

    @property
    def name(self):
        n = self.__dict__.get("_name")
        if n is None:
            n = self._name = _auto_name("tensor")
        return n

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def stop_gradient(self):
        return not _TensorBase.requires_grad.__get__(self)

    @stop_gradient.setter
    def stop_gradient(self, value):
        if value and not _TensorBase.is_leaf.__get__(self):
            raise RuntimeError(
                "stop_gradient=True on a tensor that is not a leaf: torch "
                "cannot cut a recorded graph in place; use detach()")
        _TensorBase.requires_grad_(self, not value)

    persistable = False

    # -- host interop ---------------------------------------------------
    def numpy(self):
        return host_array(self)

    def __array__(self, dtype=None):
        arr = host_array(self)
        return arr.astype(dtype) if dtype is not None else arr

    def block_until_ready(self):
        if _TensorBase.is_cuda.__get__(self):
            torch.cuda.synchronize(_TensorBase.device.__get__(self))
        return self

    def __repr__(self):
        grad = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype="
                f"{_NAMES.get(self.dtype, self.dtype)}, place={self.place}"
                f"{grad},\n       {host_array(self)!r})")

    # -- autograd ---------------------------------------------------------
    @property
    def grad(self):
        g = _TensorBase.grad.__get__(self)
        return None if g is None else wrap(g.detach())

    @grad.setter
    def grad(self, value):
        _TensorBase.grad.__set__(self, None if value is None
                                 else unwrap(value))

    def backward(self, grad_tensor=None, retain_graph=False):
        from . import autograd
        autograd.backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        _TensorBase.grad.__set__(self, None)

    clear_gradient = clear_grad

    def retain_grads(self):
        if not _TensorBase.is_leaf.__get__(self):
            _TensorBase.retain_grad(self)

    # -- mutation ---------------------------------------------------------
    def set_value(self, value):
        _set_value(self, value)

    def copy_(self, other):
        _set_value(self, other)
        return self

    def __len__(self):
        s = _TensorBase.shape.__get__(self)
        if not s:
            raise TypeError("len() of a 0-d tensor")
        return s[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # The reference's math, manipulation and statistics methods are set by
    # ``paddle_tpu_torch.ops`` (its ``_patch_tensor``), as the reference's
    # ``ops/__init__.py`` sets them.


_NOWRAP = set(torch.overrides.get_default_nowrap_functions())

_count = [0]


def _auto_name(prefix):
    _count[0] += 1
    return f"{prefix}_{_count[0]}"


def _set_value(t, value):
    """Copy ``value`` into ``t`` in place (its shape must match)."""
    if isinstance(value, torch.Tensor):
        src = unwrap(value).detach()
    else:
        src = _as_torch(value, device=_TensorBase.device.__get__(t))
    shape = tuple(_TensorBase.shape.__get__(t))
    if tuple(src.shape) != shape:
        raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} vs "
                         f"{list(shape)}")
    with torch.no_grad():
        _TensorBase.copy_(t, src)


class Parameter(torch.nn.Parameter):
    """A trainable parameter (the reference's ``ParamBase``): a
    ``torch.nn.Parameter`` with torch's meaning for torch's names (module
    docstring) and the reference's ``stop_gradient``, ``trainable``,
    ``persistable``, ``set_value``, ``clear_grad`` and the rest."""

    def __new__(cls, data, dtype=None, name=None, trainable=True):
        t = _as_torch(data, dtype)
        grad = bool(trainable) and (t.is_floating_point() or t.is_complex())
        return torch.Tensor._make_subclass(cls, t, grad)

    def __init__(self, data, dtype=None, name=None, trainable=True):
        if name is not None:
            self.param_name = self._attr_name = name
        self._state_uid = state.register(self)

    persistable = True

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def place(self):
        return self.device

    def set_value(self, value):
        _set_value(self, value)

    def clear_grad(self):
        self.grad = None
        self.__dict__.pop("_sparse_grad", None)

    clear_gradient = clear_grad

    def retain_grads(self):
        pass  # a leaf keeps its gradient

    def block_until_ready(self):
        if self.is_cuda:
            torch.cuda.synchronize(self.device)
        return self

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = torch.Tensor._make_subclass(
            type(self), self.data.clone(memory_format=torch.preserve_format),
            self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(_own_state(self), memo))
        out._state_uid = state.register(out)
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter, (self.data, self.requires_grad,
                                     _own_state(self)))

    def __repr__(self):
        return "Parameter containing:\n" + torch.Tensor.__repr__(
            self.detach())


def _own_state(p):
    """A parameter's attributes that a copy takes (not its gradient or its
    registry entry)."""
    return {k: v for k, v in p.__dict__.items()
            if k not in ("_sparse_grad", "_state_uid")}


def _rebuild_parameter(data, requires_grad, attrs):
    p = torch.Tensor._make_subclass(Parameter, data, requires_grad)
    p.__dict__.update(attrs)
    p._state_uid = state.register(p)
    return p


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``data`` (a tensor, numpy array, scalar or nested list) as a
    ``Tensor`` leaf on the card, unless ``place`` asks for the CPU
    (``"cpu"``); numpy's dtype is kept unless ``dtype`` names another
    (Python floats are float32, Python ints int64). ``stop_gradient=False``
    makes it require grad."""
    where = resolve_device(place)
    t = _as_torch(data, dtype, where)
    if isinstance(data, torch.Tensor) and t.data_ptr() == \
            data.data_ptr() and t.numel():
        t = t.clone()  # to_tensor copies, as the reference's does
    return torch.Tensor._make_subclass(Tensor, t, not stop_gradient)


# -- sparse (row) gradients ------------------------------------------------

def accumulate_sparse(p, rows):
    """Add a ``SelectedRows`` gradient to parameter ``p``: onto an earlier
    sparse one by ``merge_add``; onto a dense one as a dense sum."""
    prior = p.__dict__.get("_sparse_grad")
    p._sparse_grad = rows if prior is None else prior.merge_add(rows)


def grad_of(p):
    """The gradient the optimizer applies to ``p``: its dense ``grad``, its
    sparse one, or (both present) their dense sum, in the dense
    gradient's dtype."""
    sparse = p.__dict__.get("_sparse_grad")
    g = p.grad
    if sparse is None:
        return g
    if g is None:
        return sparse
    return g + sparse.to_dense().to(g.dtype)


def fold_sparse(p):
    """Make ``p``'s gradient one tensor where it has a dense and a sparse
    one (their dense sum in ``p.grad``); returns :func:`grad_of`."""
    g = grad_of(p)
    if p.grad is not None and p.__dict__.pop("_sparse_grad", None) \
            is not None:
        p.grad = g
    return g


def clear_grads(params):
    """Drop the dense and the sparse gradients of ``params``."""
    for p in params:
        p.grad = None
        p.__dict__.pop("_sparse_grad", None)
