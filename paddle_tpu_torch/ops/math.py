"""Math, elementwise, reduction and linalg ops (counterpart:
``paddle_tpu/ops/math.py``).

Each op is a torch operation with its gradient. It takes ``Tensor``s,
plain tensors, numpy arrays or scalars, and returns ``Tensor``s
(:func:`op`); the ops of ``amp.auto_cast``'s lists cast their inputs as
the active state says, as the reference's dispatcher does. Creation ops
take the port's ``device`` keyword (the card unless it says the CPU);
host data with no tensor operand to follow goes to the card too
(``core.device``'s rule: without a GPU it raises).
Where the reference's result narrows 64-bit integers to 32 bits (jax
without 64-bit types) the port keeps torch's int64.
"""
import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.tensor import boundary, unwrap

__all__ = [
    "to_value", "full", "zeros", "ones", "zeros_like", "empty",
    "empty_like", "is_empty", "ones_like", "full_like", "arange",
    "linspace", "eye", "tril", "triu", "diag", "exp", "log", "log2",
    "log10", "log1p", "sqrt", "rsqrt", "square", "abs", "sign", "neg",
    "reciprocal", "floor", "ceil", "round", "sin", "cos", "tan", "asin",
    "acos", "atan", "sinh", "cosh", "tanh", "erf", "expm1", "logit",
    "isnan", "isinf", "isfinite", "clip", "add", "subtract", "multiply",
    "divide", "floor_divide", "mod", "pow", "maximum", "minimum", "atan2",
    "scale", "equal", "not_equal", "greater_than", "greater_equal",
    "less_than", "less_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "allclose", "equal_all", "where", "nonzero", "sum",
    "mean", "max", "min", "prod", "std", "var", "logsumexp", "all", "any",
    "argmax", "argmin", "argsort", "sort", "topk", "cumsum", "cumprod",
    "matmul", "dot", "bmm", "mm", "t", "norm", "einsum", "multiply_sum",
    "addmm", "cast"]


def op(fn):
    """The ops' boundary: ``Tensor`` arguments reach ``fn`` as plain
    tensors, and its tensor results come back as ``Tensor``s, whatever
    it was given. ``fn`` itself is the op's ``__wrapped__`` (``ops.plain``
    holds the bodies the models call). Under an op observer it is the
    op ``fn.__name__``, the reference's name for it."""
    return boundary(fn, always=True, op_name=fn.__name__)


def amp(name, *tensors):
    """``tensors`` cast as ``auto_cast`` wants them for op ``name``."""
    # imported here: the amp package imports the layers, which import ops
    from ..amp.auto_cast import cast_inputs, get_amp_state
    if not get_amp_state().enabled:
        return tensors
    return cast_inputs(name, *tensors)


def tensor_like(v, like):
    """``v`` as a tensor on ``like``'s device (with no tensor ``like``,
    host data goes to the card: ``core.device``'s rule); a Python scalar
    takes the dtype torch would give it beside ``like``."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, int, float)) and isinstance(like, torch.Tensor):
        return torch.scalar_tensor(v, dtype=torch.result_type(like, v),
                                   device=like.device)
    dev = like.device if isinstance(like, torch.Tensor) \
        else resolve_device(None)
    arr = np.asarray(v)
    if arr.dtype == np.float64 and not isinstance(v, np.ndarray):
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=dev)


def pair(x, y):
    """Two operands as tensors (one may be a scalar or an array)."""
    if not isinstance(x, torch.Tensor):
        x = tensor_like(x, y)
    if not isinstance(y, torch.Tensor):
        y = tensor_like(y, x)
    return x, y


def axes(axis):
    """A reduction axis as torch's ``dim``: None, an int or a tuple."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(unwrap(axis)) if isinstance(axis, torch.Tensor) else int(axis)


def dims(x, axis):
    """Every dim when ``axis`` is None (torch's reductions that need one)."""
    a = axes(axis)
    return tuple(range(x.dim())) if a is None else a


def shape_list(shape):
    if isinstance(shape, torch.Tensor):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [s if isinstance(s, torch.SymInt) else int(s) for s in shape]


def floating(x):
    """Integer and bool inputs of a mean-like op as float32."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


# ---------------------------------------------------------------- creation

@op
def to_value(x):
    return x


@op
def full(shape, fill_value, dtype="float32", device=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return torch.full(shape_list(shape), fill_value,
                      dtype=convert_dtype(dtype),
                      device=resolve_device(device))


def zeros(shape, dtype="float32", device=None):
    return full(shape, 0, dtype, device=device)


def ones(shape, dtype="float32", device=None):
    return full(shape, 1, dtype, device=device)


@op
def zeros_like(x, dtype=None):
    return torch.zeros_like(tensor_like(x, None), dtype=convert_dtype(dtype))


def empty(shape, dtype="float32", device=None):
    """Zeros, as the reference's (a deterministic allocation)."""
    return zeros(shape, dtype, device=device)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


@op
def is_empty(x):
    x = tensor_like(x, None)
    return torch.tensor(x.numel() == 0, device=x.device)


@op
def ones_like(x, dtype=None):
    return torch.ones_like(tensor_like(x, None), dtype=convert_dtype(dtype))


@op
def full_like(x, fill_value, dtype=None):
    return torch.full_like(tensor_like(x, None), fill_value,
                           dtype=convert_dtype(dtype))


@op
def arange(start=0, end=None, step=1, dtype=None, device=None):
    if end is None:
        start, end = 0, start
    start, end, step = (v.item() if isinstance(v, torch.Tensor) else v
                        for v in (start, end, step))
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=resolve_device(device))


@op
def linspace(start, stop, num, dtype="float32", device=None):
    start, stop = (v.item() if isinstance(v, torch.Tensor) else v
                   for v in (start, stop))
    return torch.linspace(start, stop, int(num), dtype=convert_dtype(dtype),
                          device=resolve_device(device))


@op
def eye(num_rows, num_columns=None, dtype="float32", device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=convert_dtype(dtype),
                     device=resolve_device(device))


@op
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@op
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@op
def diag(x, offset=0):
    return torch.diag(x, offset)


# ------------------------------------------------------------- elementwise

def _unary(torch_fn, name, cast=False):
    def fn(x):
        x = tensor_like(x, None)
        if cast:
            (x,) = amp(name, x)
        return torch_fn(x)
    fn.__name__ = fn.__qualname__ = name
    return op(fn)


exp = _unary(torch.exp, "exp", cast=True)
log = _unary(torch.log, "log", cast=True)
log2 = _unary(torch.log2, "log2")
log10 = _unary(torch.log10, "log10")
log1p = _unary(torch.log1p, "log1p")
sqrt = _unary(torch.sqrt, "sqrt")
rsqrt = _unary(torch.rsqrt, "rsqrt")
square = _unary(torch.square, "square")
abs = _unary(torch.abs, "abs")  # noqa: A001 - paddle API name
sign = _unary(torch.sign, "sign")
neg = _unary(torch.neg, "neg")
reciprocal = _unary(torch.reciprocal, "reciprocal")
floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")  # noqa: A001 - half to even, as jnp
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
asin = _unary(torch.asin, "asin")
acos = _unary(torch.acos, "acos")
atan = _unary(torch.atan, "atan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
erf = _unary(torch.erf, "erf")
expm1 = _unary(torch.expm1, "expm1")
isnan = _unary(torch.isnan, "isnan")
isinf = _unary(torch.isinf, "isinf")
isfinite = _unary(torch.isfinite, "isfinite")


@op
def logit(x, eps=None):
    if eps is not None:
        x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op
def clip(x, min=None, max=None):  # noqa: A002
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    return torch.clamp(x, lo, hi)


# ------------------------------------------------------------------ binary

def _binary(torch_fn, name):
    def fn(x, y):
        return torch_fn(*pair(x, y))
    fn.__name__ = fn.__qualname__ = name
    return op(fn)


add = _binary(torch.add, "add")
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")
divide = _binary(torch.true_divide, "divide")
floor_divide = _binary(
    lambda a, b: torch.div(a, b, rounding_mode="floor"), "floor_divide")
mod = _binary(torch.remainder, "mod")  # the divisor's sign, as jnp.mod
pow = _binary(torch.pow, "pow")  # noqa: A001
maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
atan2 = _binary(torch.atan2, "atan2")


@op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    x = tensor_like(x, None)
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act is not None:
        from ..nn import functional as F
        out = unwrap(getattr(F, act)(out))
    return out


# -------------------------------------------------------------- comparison

equal = _binary(torch.eq, "equal")
not_equal = _binary(torch.ne, "not_equal")
greater_than = _binary(torch.gt, "greater_than")
greater_equal = _binary(torch.ge, "greater_equal")
less_than = _binary(torch.lt, "less_than")
less_equal = _binary(torch.le, "less_equal")
logical_and = _binary(torch.logical_and, "logical_and")
logical_or = _binary(torch.logical_or, "logical_or")
logical_xor = _binary(torch.logical_xor, "logical_xor")
logical_not = _unary(torch.logical_not, "logical_not")


@op
def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = pair(x, y)
    return torch.tensor(torch.allclose(x, y.to(x.dtype), rtol=rtol,
                                       atol=atol, equal_nan=equal_nan),
                        device=x.device)


@op
def equal_all(x, y):
    x, y = pair(x, y)
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


@op
def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x, y = pair(x, y)
    return torch.where(tensor_like(condition, x).bool(), x, y)


@op
def nonzero(x, as_tuple=False):
    """The indices of the nonzero entries (a data-dependent size: read on
    the host, as the reference's)."""
    x = tensor_like(x, None)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


# -------------------------------------------------------------- reductions

@op
def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    (x,) = amp("sum", tensor_like(x, None))
    return torch.sum(x, dim=dims(x, axis), keepdim=keepdim,
                     dtype=convert_dtype(dtype))


@op
def mean(x, axis=None, keepdim=False):
    (x,) = amp("mean", floating(tensor_like(x, None)))
    return torch.mean(x, dim=dims(x, axis), keepdim=keepdim)


@op
def max(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amax(x, dim=dims(x, axis), keepdim=keepdim)


@op
def min(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amin(x, dim=dims(x, axis), keepdim=keepdim)


@op
def prod(x, axis=None, keepdim=False, dtype=None):
    dt = convert_dtype(dtype)
    if axis is None:
        out = torch.prod(x, dtype=dt)
        return out.reshape([1] * x.dim()) if keepdim else out
    for a in sorted((d % x.dim() for d in (
            axes(axis) if isinstance(axes(axis), tuple) else (axes(axis),))),
            reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim, dtype=dt)
    return x


@op
def std(x, axis=None, unbiased=True, keepdim=False):
    x = floating(x)
    return torch.std(x, dim=dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@op
def var(x, axis=None, unbiased=True, keepdim=False):
    x = floating(x)
    return torch.var(x, dim=dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@op
def logsumexp(x, axis=None, keepdim=False):
    (x,) = amp("logsumexp", x)
    return torch.logsumexp(x, dim=dims(x, axis), keepdim=keepdim)


@op
def all(x, axis=None, keepdim=False):  # noqa: A001
    return torch.all(x.bool(), dim=dims(x, axis), keepdim=keepdim)


@op
def any(x, axis=None, keepdim=False):  # noqa: A001
    return torch.any(x.bool(), dim=dims(x, axis), keepdim=keepdim)


def _arg(torch_fn):
    def fn(x, axis=None, keepdim=False, dtype="int64"):
        if axis is None:
            out = torch_fn(x.reshape(-1))
            if keepdim:
                out = out.reshape([1] * x.dim())
        else:
            out = torch_fn(x, dim=int(axis), keepdim=keepdim)
        return out.to(convert_dtype(dtype))
    return fn


@op
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax)(x, axis, keepdim, dtype)


@op
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin)(x, axis, keepdim, dtype)


@op
def argsort(x, axis=-1, descending=False):
    """Stable ascending order; ``descending`` is its reversal, as the
    reference's."""
    idx = torch.argsort(x, dim=axis, stable=True)
    return idx.flip(axis) if descending else idx


@op
def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=axis, stable=True).values
    return out.flip(axis) if descending else out


@op
def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    """(values, int64 indices) of the k largest (smallest) along axis."""
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    res = torch.topk(x, k, dim=axis, largest=largest, sorted=sorted)
    return res.values, res.indices


@op
def cumsum(x, axis=None, dtype=None):
    (x,) = amp("cumsum", x)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=convert_dtype(dtype))
    return torch.cumsum(x, int(axis), dtype=convert_dtype(dtype))


@op
def cumprod(x, dim=None, dtype=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=convert_dtype(dtype))
    return torch.cumprod(x, int(dim), dtype=convert_dtype(dtype))


# ------------------------------------------------------------------ linalg

@op
def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = amp("matmul", *pair(x, y))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@op
def dot(x, y):
    x, y = amp("dot", *pair(x, y))
    return torch.sum(x * y, dim=-1)


@op
def bmm(x, y):
    x, y = amp("bmm", x, y)
    return torch.matmul(x, y)


@op
def mm(x, y):
    x, y = amp("mm", x, y)
    return torch.matmul(x, y)


@op
def t(x):
    """Every axis reversed (``x.T`` of numpy)."""
    return x.permute(*reversed(range(x.dim())))


@op
def norm(x, p=2, axis=None, keepdim=False):
    (x,) = amp("norm", floating(x))
    d = dims(x, axis)
    if p == "fro" or p == 2:
        return torch.sqrt(torch.sum(torch.square(x), dim=d, keepdim=keepdim))
    if p == 1:
        return torch.sum(torch.abs(x), dim=d, keepdim=keepdim)
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=d, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=d,
                               keepdim=keepdim), 1.0 / p)


@op
def einsum(equation, *operands):
    return torch.einsum(equation, *amp("einsum", *operands))


@op
def multiply_sum(x, y):
    x, y = pair(x, y)
    return torch.sum(x * y)


@op
def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    input, x, y = amp("addmm", input, x, y)
    return beta * input + alpha * torch.matmul(x, y)


@op
def cast(x, dtype):
    return tensor_like(x, None).to(convert_dtype(dtype))

