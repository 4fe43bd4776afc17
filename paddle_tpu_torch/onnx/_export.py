"""``torch.export`` graph → ONNX graph (counterpart:
``paddle_tpu/onnx/_export.py``, which walks the layer's JAXPR).

The exporter walks the eval forward's ``torch.export`` program,
decomposed to core ATen operators, and maps each operator onto the
opset-13 ONNX operators the reference's converter emits (``Add``, ``Sub``,
``Mul``, ``Div``, ``Pow``, ``Max``, ``Min``, the unary math, the
comparisons, ``Not``, ``Where``, the reductions, ``ArgMax``/``ArgMin``,
``Cast``, ``MatMul``, ``Conv``, ``MaxPool``, ``AveragePool``, ``Gather``,
``Reshape``, ``Transpose``, ``Expand``, ``Concat``, ``Slice``, ``Pad``,
``Identity``). Operators that ATen keeps whole and JAX had already
decomposed are decomposed here in the same way: softmax into
``ReduceMax``/``Sub``/``Exp``/``ReduceSum``/``Div``, layer and batch norm,
GELU through ``Erf`` (or ``Tanh``), ReLU as ``Max(x, 0)``. So the nodes
may differ from the reference's (a deliberate difference); what the file
computes is the same. ``ReduceMax``/``ReduceMin``/``ReduceProd`` take
their axes as an attribute, as opset 13 defines them.

Parameters and buffers become initializers; creation operators (``arange``,
``full``) are evaluated at export and stored as initializers; shapes are
the traced ones. An operator with no mapping (``aten::cumsum``, the custom
operator ``paddle_tpu_torch::flash_attention_fwd``) raises
:class:`UnsupportedPrimitive` naming every such operator of the graph
before anything is written.
"""
import math
import operator

import numpy as np
import torch

from . import _proto as P

_DTYPE = {
    torch.float32: P.FLOAT, torch.float64: P.DOUBLE, torch.int32: P.INT32,
    torch.int64: P.INT64, torch.bool: P.BOOL, torch.float16: P.FLOAT16,
    torch.int8: P.INT8, torch.uint8: P.UINT8,
}
_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
       torch.float16: np.float16, torch.int8: np.int8, torch.uint8: np.uint8}


class UnsupportedPrimitive(NotImplementedError):
    pass


def _np(t):
    t = t.detach().cpu()
    if t.dtype not in _NP:
        raise UnsupportedPrimitive(f"tensor dtype {t.dtype} has no ONNX type "
                                   "in this exporter")
    return t.numpy()


class _Graph:
    def __init__(self):
        self.nodes = []         # (op_type, inputs, outputs, attrs)
        self.initializers = {}  # name -> (dims, data_type, raw)
        self._n = 0
        self.names = {}         # fx node -> onnx name (or list of names)
        self.dtypes = {}        # onnx name -> torch dtype

    def fresh(self, hint="t"):
        self._n += 1
        return f"{hint}_{self._n}"

    def add(self, op, inputs, dtype, attrs=(), hint=None):
        out = self.fresh(hint or op.lower())
        self.nodes.append((op, list(inputs), [out], list(attrs)))
        self.dtypes[out] = dtype
        return out

    def const(self, arr, hint="const", dtype=None):
        arr = np.asarray(arr).copy(order="C")  # a 0-d array stays 0-d
        name = self.fresh(hint)
        tdtype = dtype or torch.from_numpy(arr.reshape(-1)[:0].copy()).dtype
        self.initializers[name] = (arr.shape, _DTYPE[tdtype], arr.tobytes())
        self.dtypes[name] = tdtype
        return name

    def scalar(self, v, dtype):
        return self.const(np.asarray(v, _NP[dtype]), "scalar", dtype)

    def ints(self, vals, hint="ints"):
        return self.const(np.asarray(vals, np.int64), hint, torch.int64)

    def cast(self, name, dtype):
        if self.dtypes[name] == dtype:
            return name
        return self.add("Cast", [name], dtype,
                        [P.attr_i("to", _DTYPE[dtype])])

    def prune(self, output_names):
        """Drop nodes and initializers the outputs do not reach."""
        needed = set(output_names)
        kept = []
        for op, ins, outs, attrs in reversed(self.nodes):
            if any(o in needed for o in outs):
                kept.append((op, ins, outs, attrs))
                needed.update(ins)
        self.nodes = list(reversed(kept))
        self.initializers = {k: v for k, v in self.initializers.items()
                             if k in needed}

    def serialize(self):
        nodes = [P.node_proto(op, ins, outs, name=f"n{i}", attrs=attrs)
                 for i, (op, ins, outs, attrs) in enumerate(self.nodes)]
        inits = [P.tensor_proto(name, dims, dt, raw)
                 for name, (dims, dt, raw) in self.initializers.items()]
        return nodes, inits


def _val(node):
    return node.meta["val"]


def _op_name(target):
    schema = getattr(target, "_schema", None)
    return schema.name if schema is not None else str(target)


class _Ctx:
    """One node's conversion: its operands as ONNX names of a dtype."""

    def __init__(self, g, node):
        self.g, self.node = g, node
        val = _val(node)
        self.out = val if isinstance(val, torch.Tensor) else None

    @property
    def dtype(self):
        return self.out.dtype

    @property
    def shape(self):
        return [int(d) for d in self.out.shape]

    def name(self, arg, dtype=None):
        """``arg`` (a node or a Python scalar) as an ONNX name, cast to
        ``dtype`` when given."""
        g = self.g
        if hasattr(arg, "op"):
            name = g.names[arg]
        else:
            return g.scalar(arg, dtype or self.dtype)
        return g.cast(name, dtype) if dtype is not None else name

    def add(self, op, inputs, dtype=None, attrs=()):
        return self.g.add(op, inputs, dtype or self.dtype, attrs)


def _rank(node):
    return _val(node).dim()


def _axis(a, rank):
    return a + rank if a < 0 else a


def _axes(dims, rank):
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return list(range(rank))
    if isinstance(dims, int):
        dims = [dims]
    return [_axis(d, rank) for d in dims]


# ---- the conversions -------------------------------------------------------

_UNARY = {"aten::exp": "Exp", "aten::log": "Log", "aten::tanh": "Tanh",
          "aten::sigmoid": "Sigmoid", "aten::sqrt": "Sqrt", "aten::abs": "Abs",
          "aten::erf": "Erf", "aten::floor": "Floor", "aten::ceil": "Ceil",
          "aten::sign": "Sign", "aten::sin": "Sin", "aten::cos": "Cos",
          "aten::neg": "Neg", "aten::logical_not": "Not"}
_BINARY = {"aten::add": "Add", "aten::sub": "Sub", "aten::mul": "Mul",
           "aten::div": "Div", "aten::pow": "Pow", "aten::maximum": "Max",
           "aten::minimum": "Min"}
_COMPARE = {"aten::gt": "Greater", "aten::lt": "Less",
            "aten::ge": "GreaterOrEqual", "aten::le": "LessOrEqual",
            "aten::eq": "Equal", "aten::ne": "Equal"}
_CREATE = {"aten::arange", "aten::full", "aten::scalar_tensor"}
_SKIP = {"aten::_assert_tensor_metadata", "aten::_assert_scalar",
         "aten::sym_constrain_range_for_size"}


def _unary(c, args, kw):
    return c.add(_UNARY[_op_name(c.node.target)], [c.name(args[0])])


def _binary(c, args, kw):
    op = _op_name(c.node.target)
    if kw.get("alpha", 1) != 1 or (len(args) > 2 and args[2] != 1):
        raise UnsupportedPrimitive(f"{op} with alpha != 1")
    if op == "aten::div" and kw.get("rounding_mode") is not None:
        raise UnsupportedPrimitive(f"{op} with rounding_mode")
    if op == "aten::pow" and not hasattr(args[1], "op"):
        # the exponent constant in the operand's dtype (strict checkers
        # reject Pow with mixed element types)
        return c.add("Pow", [c.name(args[0]), c.g.scalar(args[1], c.dtype)])
    return c.add(_BINARY[op], [c.name(args[0], c.dtype),
                               c.name(args[1], c.dtype)])


def _compare(c, args, kw):
    op = _op_name(c.node.target)
    a, b = args[0], args[1]
    da = _val(a).dtype if hasattr(a, "op") else None
    db = _val(b).dtype if hasattr(b, "op") else None
    dt = (torch.promote_types(da, db) if da is not None and db is not None
          else da or db)
    out = c.add(_COMPARE[op], [c.name(a, dt), c.name(b, dt)],
                dtype=torch.bool)
    return c.add("Not", [out], dtype=torch.bool) if op == "aten::ne" else out


def _logical_and(c, args, kw):
    a, b = c.name(args[0], torch.bool), c.name(args[1], torch.bool)
    return c.add("Where", [a, b, c.g.scalar(False, torch.bool)],
                 dtype=torch.bool)


def _where(c, args, kw):
    return c.add("Where", [c.name(args[0], torch.bool),
                           c.name(args[1], c.dtype), c.name(args[2], c.dtype)])


def _relu(c, args, kw):
    return c.add("Max", [c.name(args[0]), c.g.scalar(0, c.dtype)])


def _clamp(c, args, kw):
    x = c.name(args[0], c.dtype)
    lo = args[1] if len(args) > 1 else kw.get("min")
    hi = args[2] if len(args) > 2 else kw.get("max")
    if lo is not None:
        x = c.add("Max", [x, c.name(lo, c.dtype)])
    if hi is not None:
        x = c.add("Min", [x, c.name(hi, c.dtype)])
    return x


def _rsqrt(c, args, kw):
    s = c.add("Sqrt", [c.name(args[0])])
    return c.add("Div", [c.g.scalar(1.0, c.dtype), s])


def _reciprocal(c, args, kw):
    return c.add("Div", [c.g.scalar(1.0, c.dtype), c.name(args[0])])


def _reduce(g, op, x, axes, keepdims, dtype):
    if op == "ReduceSum":  # opset 13: axes an input
        return g.add(op, [x, g.ints(axes, "axes")], dtype,
                     [P.attr_i("keepdims", int(keepdims))])
    return g.add(op, [x], dtype, [P.attr_ints("axes", axes),
                                  P.attr_i("keepdims", int(keepdims))])


def _reduction(c, args, kw, op):
    rank = _rank(args[0])
    dims = args[1] if len(args) > 1 else kw.get("dim")
    keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
    x = c.name(args[0], c.dtype)
    return _reduce(c.g, op, x, _axes(dims, rank), keep, c.dtype)


def _mean(c, args, kw):
    rank = _rank(args[0])
    dims = args[1] if len(args) > 1 else kw.get("dim")
    keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
    axes = _axes(dims, rank)
    shape = _val(args[0]).shape
    count = math.prod(int(shape[a]) for a in axes)
    s = _reduce(c.g, "ReduceSum", c.name(args[0], c.dtype), axes, keep,
                c.dtype)
    return c.add("Div", [s, c.g.scalar(count, c.dtype)])


def _arg(c, args, kw, op):
    rank = _rank(args[0])
    dim = args[1] if len(args) > 1 else kw.get("dim")
    keep = args[2] if len(args) > 2 else kw.get("keepdim", False)
    if dim is None:
        raise UnsupportedPrimitive(f"{op} over all axes")
    out = c.add(op, [c.name(args[0])], dtype=torch.int64,
                attrs=[P.attr_i("axis", _axis(dim, rank)),
                       P.attr_i("keepdims", int(keep))])
    return c.g.cast(out, c.dtype)


def _matmul(c, args, kw):
    return c.add("MatMul", [c.name(args[0], c.dtype),
                            c.name(args[1], c.dtype)])


def _addmm(c, args, kw):
    beta = args[3] if len(args) > 3 else kw.get("beta", 1)
    alpha = args[4] if len(args) > 4 else kw.get("alpha", 1)
    if beta != 1 or alpha != 1:
        raise UnsupportedPrimitive("aten::addmm with beta or alpha != 1")
    mm = c.add("MatMul", [c.name(args[1]), c.name(args[2])])
    return c.add("Add", [mm, c.name(args[0], c.dtype)])


def _reshape(c, args, kw):
    return c.add("Reshape", [c.name(args[0]), c.g.ints(c.shape, "shape")])


def _permute(c, args, kw):
    perm = [_axis(p, _rank(args[0])) for p in args[1]]
    return c.add("Transpose", [c.name(args[0])],
                 attrs=[P.attr_ints("perm", perm)])


def _expand(c, args, kw):
    src = c.name(args[0])
    in_shape = list(_val(args[0]).shape)
    if len(in_shape) < len(c.shape):
        lead = [1] * (len(c.shape) - len(in_shape))
        src = c.add("Reshape", [src, c.g.ints(lead + in_shape, "shape")])
    return c.add("Expand", [src, c.g.ints(c.shape, "shape")])


def _identity(c, args, kw):
    return c.add("Identity", [c.name(args[0])])


def _to_copy(c, args, kw):
    return c.g.cast(c.name(args[0]), c.dtype)


def _cat(c, args, kw):
    dim = args[1] if len(args) > 1 else kw.get("dim", 0)
    return c.add("Concat", [c.name(t, c.dtype) for t in args[0]],
                 attrs=[P.attr_i("axis", _axis(dim, len(c.shape)))])


def _slice_node(g, x, in_shape, dim, start, end, step, dtype):
    size = int(in_shape[dim])
    start = 0 if start is None else start
    end = size if end is None else min(end, size)
    return g.add("Slice", [x, g.ints([start], "starts"),
                           g.ints([end], "ends"), g.ints([dim], "axes"),
                           g.ints([step], "steps")], dtype)


def _slice(c, args, kw):
    rank = _rank(args[0])
    dim = _axis(args[1] if len(args) > 1 else 0, rank)
    start = args[2] if len(args) > 2 else None
    end = args[3] if len(args) > 3 else None
    step = args[4] if len(args) > 4 else 1
    return _slice_node(c.g, c.name(args[0]), _val(args[0]).shape, dim,
                       start, end, step, c.dtype)


def _select(c, args, kw):
    rank = _rank(args[0])
    dim = _axis(args[1], rank)
    index = args[2] % int(_val(args[0]).shape[dim])
    return c.add("Gather", [c.name(args[0]), c.g.ints(index, "index")],
                 attrs=[P.attr_i("axis", dim)])


def _split(c, args, kw):
    """split_with_sizes: a list of slices (picked by getitem)."""
    x, val = c.name(args[0]), _val(args[0])
    dim = _axis(args[2] if len(args) > 2 else 0, val.dim())
    outs, start = [], 0
    for size in args[1]:
        outs.append(_slice_node(c.g, x, val.shape, dim, start, start + size,
                                1, val.dtype))
        start += size
    return outs


def _gather_rows(c, table, ids, axis=0):
    return c.add("Gather", [c.name(table), c.name(ids, torch.int64)],
                 attrs=[P.attr_i("axis", axis)])


def _embedding(c, args, kw):
    return _gather_rows(c, args[0], args[1])


def _index_select(c, args, kw):
    return _gather_rows(c, args[0], args[2], _axis(args[1], _rank(args[0])))


def _pad(c, args, kw):
    pad = list(args[1])
    value = args[2] if len(args) > 2 else kw.get("value", 0)
    rank = _rank(args[0])
    begins, ends = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):  # torch: the last dim first
        begins[rank - 1 - i], ends[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    return c.add("Pad", [c.name(args[0]), c.g.ints(begins + ends, "pads"),
                         c.g.scalar(value, c.dtype)])


def _conv(c, args, kw):
    x, w, b, stride, padding, dilation, transposed, _, groups = args[:9]
    if transposed:
        raise UnsupportedPrimitive("aten::convolution transposed")
    if isinstance(padding, str):
        raise UnsupportedPrimitive(f"aten::convolution padding {padding!r}")
    ins = [c.name(x), c.name(w)] + ([c.name(b)] if b is not None else [])
    return c.add("Conv", ins, attrs=[
        P.attr_ints("strides", stride), P.attr_ints("dilations", dilation),
        P.attr_ints("pads", list(padding) + list(padding)),
        P.attr_i("group", groups)])


def _pool_geometry(args):
    kernel = list(args[1])
    stride = list(args[2]) if len(args) > 2 and args[2] else kernel
    padding = args[3] if len(args) > 3 else 0
    padding = list(padding) if isinstance(padding, (list, tuple)) \
        else [padding] * len(kernel)
    if len(padding) == 1:
        padding = padding * len(kernel)
    return kernel, stride, padding


def _max_pool(c, args, kw):
    kernel, stride, padding = _pool_geometry(args)
    dilation = list(args[4]) if len(args) > 4 else [1]
    ceil = args[5] if len(args) > 5 else False
    if any(d != 1 for d in dilation):
        raise UnsupportedPrimitive(f"aten::max_pool2d dilation {dilation}")
    out = c.g.add("MaxPool", [c.name(args[0])], _val(args[0]).dtype, [
        P.attr_ints("kernel_shape", kernel), P.attr_ints("strides", stride),
        P.attr_ints("pads", padding + padding),
        P.attr_i("ceil_mode", int(ceil))])
    return [out, None]  # the indices have no mapping


def _avg_pool(c, args, kw):
    kernel, stride, padding = _pool_geometry(args)
    ceil = args[4] if len(args) > 4 else False
    include = args[5] if len(args) > 5 else True
    if len(args) > 6 and args[6] is not None:
        raise UnsupportedPrimitive("aten::avg_pool2d divisor_override")
    return c.add("AveragePool", [c.name(args[0])], attrs=[
        P.attr_ints("kernel_shape", kernel), P.attr_ints("strides", stride),
        P.attr_ints("pads", padding + padding),
        P.attr_i("ceil_mode", int(ceil)),
        P.attr_i("count_include_pad", int(include))])


def _per_channel(c, t, rank, axis=1):
    """A [C] parameter reshaped to broadcast along ``axis``."""
    shape = [1] * rank
    shape[axis] = -1
    return c.add("Reshape", [c.name(t, c.dtype), c.g.ints(shape, "shape")])


def _batch_norm(c, args, kw):
    x, w, b, mean, var = args[:5]
    eps = args[6]
    out_val = _val(c.node)[0]
    c.out = out_val
    rank = out_val.dim()
    y = c.add("Sub", [c.name(x), _per_channel(c, mean, rank)])
    std = c.add("Sqrt", [c.add("Add", [_per_channel(c, var, rank),
                                       c.g.scalar(eps, c.dtype)])])
    y = c.add("Div", [y, std])
    if w is not None:
        y = c.add("Mul", [y, _per_channel(c, w, rank)])
    if b is not None:
        y = c.add("Add", [y, _per_channel(c, b, rank)])
    return [y, None, None]


def _layer_norm(c, args, kw):
    x, normalized_shape, w, b, eps = args[:5]
    out_val = _val(c.node)[0]
    c.out = out_val
    rank = out_val.dim()
    axes = list(range(rank - len(normalized_shape), rank))
    n = math.prod(normalized_shape)
    xn = c.name(x)
    mean = c.add("Div", [_reduce(c.g, "ReduceSum", xn, axes, True, c.dtype),
                         c.g.scalar(n, c.dtype)])
    d = c.add("Sub", [xn, mean])
    var = c.add("Div", [_reduce(c.g, "ReduceSum", c.add("Mul", [d, d]), axes,
                                True, c.dtype), c.g.scalar(n, c.dtype)])
    y = c.add("Div", [d, c.add("Sqrt", [c.add(
        "Add", [var, c.g.scalar(eps, c.dtype)])])])
    if w is not None:
        y = c.add("Mul", [y, c.name(w, c.dtype)])
    if b is not None:
        y = c.add("Add", [y, c.name(b, c.dtype)])
    return [y, None, None]


def _softmax(c, args, kw, log=False):
    x = c.name(args[0], c.dtype)
    axis = [_axis(args[1], _rank(args[0]))]
    m = _reduce(c.g, "ReduceMax", x, axis, True, c.dtype)
    shifted = c.add("Sub", [x, m])
    e = c.add("Exp", [shifted])
    s = _reduce(c.g, "ReduceSum", e, axis, True, c.dtype)
    if log:
        return c.add("Sub", [shifted, c.add("Log", [s])])
    return c.add("Div", [e, s])


def _gelu(c, args, kw):
    x = c.name(args[0])
    approx = kw.get("approximate", args[1] if len(args) > 1 else "none")
    half = c.add("Mul", [x, c.g.scalar(0.5, c.dtype)])
    if approx == "tanh":
        cube = c.add("Pow", [x, c.g.scalar(3.0, c.dtype)])
        inner = c.add("Add", [x, c.add("Mul", [cube, c.g.scalar(
            0.044715, c.dtype)])])
        t = c.add("Tanh", [c.add("Mul", [inner, c.g.scalar(
            math.sqrt(2.0 / math.pi), c.dtype)])])
    else:
        t = c.add("Erf", [c.add("Div", [x, c.g.scalar(math.sqrt(2.0),
                                                      c.dtype)])])
    return c.add("Mul", [half, c.add("Add", [t, c.g.scalar(1.0, c.dtype)])])


def _create(c, args, kw):
    """Creation operators have no tensor input: evaluated now."""
    kw = dict(kw, device="cpu")
    kw.pop("pin_memory", None)
    value = c.node.target(*args, **kw)
    return c.g.const(_np(value), "created", value.dtype)


_TABLE = {"aten::relu": _relu, "aten::clamp": _clamp, "aten::rsqrt": _rsqrt,
          "aten::reciprocal": _reciprocal, "aten::where": _where,
          "aten::logical_and": _logical_and,
          "aten::sum": lambda c, a, k: _reduction(c, a, k, "ReduceSum"),
          "aten::amax": lambda c, a, k: _reduction(c, a, k, "ReduceMax"),
          "aten::amin": lambda c, a, k: _reduction(c, a, k, "ReduceMin"),
          "aten::prod": lambda c, a, k: _reduction(c, a, k, "ReduceProd"),
          "aten::mean": _mean,
          "aten::argmax": lambda c, a, k: _arg(c, a, k, "ArgMax"),
          "aten::argmin": lambda c, a, k: _arg(c, a, k, "ArgMin"),
          "aten::mm": _matmul, "aten::bmm": _matmul,
          "aten::addmm": _addmm,
          "aten::view": _reshape, "aten::_unsafe_view": _reshape,
          "aten::unsqueeze": _reshape, "aten::squeeze": _reshape,
          "aten::permute": _permute, "aten::expand": _expand,
          "aten::clone": _identity, "aten::alias": _identity,
          "aten::_to_copy": _to_copy, "aten::cat": _cat,
          "aten::slice": _slice, "aten::select": _select,
          "aten::split_with_sizes": _split,
          "aten::embedding": _embedding, "aten::index_select": _index_select,
          "aten::constant_pad_nd": _pad, "aten::convolution": _conv,
          "aten::max_pool2d_with_indices": _max_pool,
          "aten::avg_pool2d": _avg_pool,
          "aten::_native_batch_norm_legit_no_training": _batch_norm,
          "aten::native_layer_norm": _layer_norm,
          "aten::_softmax": _softmax,
          "aten::_log_softmax": lambda c, a, k: _softmax(c, a, k, log=True),
          "aten::gelu": _gelu}
for _n in _UNARY:
    _TABLE[_n] = _unary
for _n in _BINARY:
    _TABLE[_n] = _binary
for _n in _COMPARE:
    _TABLE[_n] = _compare
for _n in _CREATE:
    _TABLE[_n] = _create


def unsupported_ops(graph):
    """The names of the graph's operators that have no mapping, each once,
    in the order they first appear."""
    seen = []
    for node in graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        name = _op_name(node.target)
        if name not in _TABLE and name not in _SKIP and name not in seen:
            seen.append(name)
    return seen


def convert_program(ep, input_names):
    """``ep``: the ``torch.export`` program of the forward, decomposed to
    core ATen. Returns (_Graph, output names, output (shape, dtype)s)."""
    missing = unsupported_ops(ep.graph)
    if missing:
        raise UnsupportedPrimitive(
            "no ONNX mapping for " + ", ".join(repr(n) for n in missing)
            + " (add the operator's mapping to "
            "paddle_tpu_torch/onnx/_export.py)")
    g = _Graph()
    sig = ep.graph_signature
    lifted = dict(sig.inputs_to_parameters)
    lifted.update(sig.inputs_to_buffers)
    lifted.update(sig.inputs_to_lifted_tensor_constants)
    user = iter(input_names)
    outputs, specs = [], []
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            if node.name in lifted:
                key = lifted[node.name]
                t = ep.state_dict[key] if key in ep.state_dict \
                    else ep.constants[key]
                g.names[node] = g.const(_np(t), "w", t.dtype)
            else:
                name = next(user)
                g.names[node] = name
                g.dtypes[name] = _val(node).dtype
        elif node.op == "call_function":
            if node.target is operator.getitem:
                src = g.names[node.args[0]][node.args[1]]
                if src is None:
                    raise UnsupportedPrimitive(
                        f"output {node.args[1]} of "
                        f"{_op_name(node.args[0].target)!r}")
                g.names[node] = src
                continue
            name = _op_name(node.target)
            if name in _SKIP:
                continue
            g.names[node] = _TABLE[name](_Ctx(g, node), list(node.args),
                                         dict(node.kwargs))
        elif node.op == "output":
            for arg in node.args[0]:
                out = g.names[arg]
                outputs.append(out)
                v = _val(arg)
                specs.append(([int(d) for d in v.shape], v.dtype))
    return g, outputs, specs
