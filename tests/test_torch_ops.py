"""The port's op library (``paddle_tpu_torch.ops``: math, manipulation,
extras, random) against the reference's, on the CPU.

Each deterministic op runs on the same seeded numpy inputs in both
packages; the outputs must agree: floats within ``RTOL``/``ATOL``
(float32, the same math in another order), integers and booleans exactly,
and the dtype's kind alike (the port keeps 64-bit integers where the
reference, jax without 64-bit types, narrows them to 32 bits). The
differentiable ones also compare the gradient of ``sum(out * c)`` for a
seeded ``c``, within the same bounds. Random ops are compared by shape,
dtype and moments (threefry and Philox give other numbers), and
``get_rng_state``/``set_rng_state`` must repeat a draw bitwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def ref_t(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad) \
        if isinstance(a, np.ndarray) else a


def port_t(a, grad=False):
    return pt.to_tensor(a, place="cpu", stop_gradient=not grad) \
        if isinstance(a, np.ndarray) else a


def as_numpy(v):
    if isinstance(v, (list, tuple)):
        return [as_numpy(x) for x in v]
    if isinstance(v, torch.Tensor):
        v = v.detach()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


def compare(want, got, rtol=RTOL, atol=ATOL, what=""):
    """Nests of tensors: the same structure, shapes, dtype kinds and
    values (floats within rtol/atol, the rest exactly)."""
    w, g = as_numpy(want), as_numpy(got)
    if isinstance(w, list):
        assert isinstance(g, list) and len(w) == len(g), what
        for i, (a, b) in enumerate(zip(w, g)):
            compare(a, b, rtol, atol, f"{what}[{i}]")
        return
    assert w.shape == g.shape, (what, w.shape, g.shape)
    assert w.dtype.kind == g.dtype.kind, (what, w.dtype, g.dtype)
    if w.dtype.kind in "fc":
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def f32(*shape, lo=0.1, hi=1.0):
    def make(r):
        return (lo + (hi - lo) * r.rand(*shape)).astype(np.float32)
    return make


def normal(*shape):
    return lambda r: r.randn(*shape).astype(np.float32)


def ints(*shape, lo=0, hi=6, dtype=np.int64):
    return lambda r: r.randint(lo, hi, shape).astype(dtype)


def const(v):
    return lambda r: v


X = f32(3, 4)
N = normal(3, 4)

# name: (argument makers, keyword arguments, differentiable argument
# positions)
CASES = {
    # creation
    "full": ([const([2, 3]), const(1.5)], {}, ()),
    "zeros": ([const([2, 3])], {}, ()),
    "ones": ([const([2, 3])], {"dtype": "int32"}, ()),
    "zeros_like": ([X], {}, ()),
    "ones_like": ([X], {}, ()),
    "full_like": ([X, const(2.5)], {}, ()),
    "empty": ([const([2])], {}, ()),
    "empty_like": ([X], {}, ()),
    "is_empty": ([X], {}, ()),
    "arange": ([const(1), const(7), const(2)], {}, ()),
    "linspace": ([const(0.0), const(1.0), const(5)], {}, ()),
    "eye": ([const(3), const(4)], {}, ()),
    "tril": ([N], {"diagonal": 1}, (0,)),
    "triu": ([N], {}, (0,)),
    "diag": ([normal(4)], {}, (0,)),
    # elementwise
    **{name: ([X], {}, (0,)) for name in (
        "exp", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "square",
        "reciprocal", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
        "cosh", "tanh", "erf", "expm1")},
    **{name: ([N], {}, (0,)) for name in ("abs", "neg")},
    **{name: ([N], {}, ()) for name in ("sign", "floor", "ceil", "round",
                                        "isnan", "isinf", "isfinite")},
    "logit": ([f32(3, 4, lo=0.2, hi=0.8)], {"eps": 0.1}, (0,)),
    "clip": ([N], {"min": -0.5, "max": 0.5}, (0,)),
    # binary
    **{name: ([N, normal(3, 4)], {}, (0, 1)) for name in (
        "add", "subtract", "multiply", "maximum", "minimum", "atan2")},
    "divide": ([N, f32(3, 4, lo=0.5, hi=2.0)], {}, (0, 1)),
    "pow": ([X, f32(3, 4, lo=0.5, hi=2.0)], {}, (0, 1)),
    "mod": ([normal(3, 4), f32(3, 4, lo=0.5, hi=2.0)], {}, ()),
    "floor_divide": ([ints(3, 4, lo=-9, hi=9), ints(3, 4, lo=1, hi=4)], {},
                     ()),
    "scale": ([N], {"scale": 2.0, "bias": 0.5}, (0,)),
    # comparison and logic
    **{name: ([ints(3, 4), ints(3, 4)], {}, ()) for name in (
        "equal", "not_equal", "greater_than", "greater_equal", "less_than",
        "less_equal")},
    **{name: ([lambda r: r.rand(3, 4) > 0.5, lambda r: r.rand(3, 4) > 0.5],
              {}, ()) for name in ("logical_and", "logical_or",
                                   "logical_xor")},
    "logical_not": ([lambda r: r.rand(3, 4) > 0.5], {}, ()),
    "allclose": ([X, X], {}, ()),
    "equal_all": ([ints(3, 4), ints(3, 4)], {}, ()),
    "where": ([lambda r: r.rand(3, 4) > 0.5, N, normal(3, 4)], {}, (1, 2)),
    "nonzero": ([ints(3, 4, hi=2)], {}, ()),
    # reductions
    "sum": ([N], {"axis": 1, "keepdim": True}, (0,)),
    "mean": ([N], {"axis": [0, 1]}, (0,)),
    "max": ([N], {"axis": 0}, (0,)),
    "min": ([N], {}, (0,)),
    "prod": ([X], {"axis": 1}, (0,)),
    "std": ([N], {"axis": 1}, (0,)),
    "var": ([N], {"unbiased": False}, (0,)),
    "logsumexp": ([N], {"axis": 1}, (0,)),
    "all": ([ints(3, 4, hi=2)], {"axis": 1}, ()),
    "any": ([ints(3, 4, hi=2)], {}, ()),
    "argmax": ([N], {"axis": 1}, ()),
    "argmin": ([N], {}, ()),
    "argsort": ([N], {"axis": 0, "descending": True}, ()),
    "sort": ([N], {"descending": True}, (0,)),
    "topk": ([N], {"k": 2}, (0,)),
    "cumsum": ([N], {"axis": 1}, (0,)),
    "cumprod": ([X], {"dim": 0}, (0,)),
    # linalg
    "matmul": ([normal(3, 4), normal(5, 4)], {"transpose_y": True}, (0, 1)),
    "dot": ([normal(3, 4), normal(3, 4)], {}, (0, 1)),
    "bmm": ([normal(2, 3, 4), normal(2, 4, 5)], {}, (0, 1)),
    "mm": ([normal(3, 4), normal(4, 2)], {}, (0, 1)),
    "t": ([N], {}, (0,)),
    "norm": ([N], {"p": 2, "axis": 1}, (0,)),
    "einsum": ([const("ij,jk->ik"), normal(3, 4), normal(4, 2)], {}, (1, 2)),
    "multiply_sum": ([N, normal(3, 4)], {}, (0, 1)),
    "addmm": ([normal(3, 2), normal(3, 4), normal(4, 2)],
              {"beta": 0.5, "alpha": 2.0}, (0, 1, 2)),
    "cast": ([N, const("int32")], {}, ()),
    # manipulation
    "reshape": ([N, const([4, 3])], {}, (0,)),
    "flatten": ([normal(2, 3, 4)], {"start_axis": 1}, (0,)),
    "transpose": ([normal(2, 3, 4), const([2, 0, 1])], {}, (0,)),
    "moveaxis": ([normal(2, 3, 4), const(0), const(2)], {}, (0,)),
    "swapaxes": ([normal(2, 3, 4), const(0), const(2)], {}, (0,)),
    "squeeze": ([normal(3, 1, 4)], {"axis": [1, 2]}, (0,)),
    "unsqueeze": ([N, const([0, 3])], {}, (0,)),
    "concat": ([lambda r: [normal(2, 3)(r), normal(4, 3)(r)]], {}, ()),
    "stack": ([lambda r: [normal(2, 3)(r), normal(2, 3)(r)]], {"axis": 1},
              ()),
    "unstack": ([N], {"axis": 1}, (0,)),
    "split": ([normal(6, 4), const([1, -1, 2])], {}, (0,)),
    "chunk": ([normal(6, 4), const(3)], {}, (0,)),
    "tile": ([N, const([2, 1])], {}, (0,)),
    "expand": ([normal(1, 4), const([3, -1])], {}, (0,)),
    "expand_as": ([normal(1, 4), normal(3, 4)], {}, (0,)),
    "broadcast_to": ([normal(1, 4), const([3, 4])], {}, (0,)),
    "flip": ([N, const([0, 1])], {}, (0,)),
    "roll": ([N, const(1)], {"axis": 1}, (0,)),
    "slice": ([N, const([0, 1]), const([1, 0]), const([3, 2])], {}, (0,)),
    "strided_slice": ([normal(6, 5), const([0, 1]), const([5, 0]),
                       const([0, 5]), const([-2, 2])], {}, (0,)),
    "gather": ([N, ints(5, hi=3)], {"axis": 0}, (0,)),
    "gather_nd": ([normal(3, 4, 2), lambda r: np.array([[0, 1], [2, 3]])],
                  {}, (0,)),
    "take_along_axis": ([N, ints(3, 2, hi=4), const(1)], {}, (0,)),
    "scatter": ([normal(5, 3), lambda r: np.array([3, 0]), normal(2, 3)],
                {}, (0, 2)),
    "scatter_nd_add": ([normal(5, 3), lambda r: np.array([[1], [1], [4]]),
                        normal(3, 3)], {}, (0, 2)),
    "put_along_axis": ([N, lambda r: np.array([[1], [0], [3]]),
                        normal(3, 1), const(1)], {}, ()),
    "index_select": ([N, ints(5, hi=4)], {"axis": 1}, (0,)),
    "index_sample": ([N, ints(3, 2, hi=4)], {}, (0,)),
    "masked_select": ([N, lambda r: r.rand(3, 4) > 0.5], {}, ()),
    "masked_fill": ([N, lambda r: r.rand(3, 4) > 0.5, const(9.0)], {}, (0,)),
    "pad": ([normal(2, 3, 4), const([1, 0, 0, 2])], {"value": 1.5}, (0,)),
    "unique": ([ints(12)], {"return_counts": True, "return_inverse": True},
               ()),
    "assign": ([N], {}, (0,)),
    "numel": ([N], {}, ()),
    "shape": ([N], {}, ()),
    "meshgrid": ([normal(3), normal(4)], {}, ()),
    "repeat_interleave": ([N, const(2)], {"axis": 1}, (0,)),
    "one_hot": ([ints(5, hi=4), const(4)], {}, ()),
    "getitem": ([normal(4, 5), const((slice(1, 3), [0, 2, 4]))], {}, (0,)),
    # extras
    "median": ([normal(3, 6)], {"axis": 1}, (0,)),
    "nanmedian": ([normal(3, 5)], {}, ()),
    "kthvalue": ([N, const(2)], {}, (0,)),
    "mode": ([ints(3, 7, hi=3)], {"axis": 1}, ()),
    "quantile": ([normal(4, 5), const([0.25, 0.5])], {"axis": 1}, (0,)),
    "histogram": ([N], {"bins": 5}, ()),
    "bincount": ([ints(9, hi=5)], {"minlength": 7}, ()),
    "unique_consecutive": ([lambda r: np.array([1, 1, 2, 2, 2, 3, 1, 1])],
                           {"return_inverse": True, "return_counts": True},
                           ()),
    "diff": ([N], {"axis": 1}, (0,)),
    "trace": ([normal(4, 4)], {"offset": 1}, (0,)),
    "kron": ([normal(2, 2), normal(2, 3)], {}, (0, 1)),
    "outer": ([normal(3), normal(4)], {}, (0, 1)),
    "cross": ([normal(2, 3), normal(2, 3)], {}, (0, 1)),
    "diagonal": ([normal(3, 4)], {"offset": -1}, (0,)),
    "rot90": ([N], {"k": 3}, (0,)),
    "searchsorted": ([lambda r: np.array([1.0, 3.0, 5.0, 7.0], np.float32),
                      normal(5)], {}, ()),
    "bucketize": ([normal(5), lambda r: np.array([-1.0, 0.0, 1.0],
                                                 np.float32)], {}, ()),
    "take": ([N, lambda r: np.array([0, 5, 11, -1])], {}, (0,)),
    "lerp": ([N, normal(3, 4), const(0.25)], {}, (0, 1)),
    "trunc": ([N], {}, ()),
    "frac": ([N], {}, (0,)),
    "nanmean": ([N], {"axis": 0}, (0,)),
    "nansum": ([N], {}, (0,)),
    "deg2rad": ([N], {}, (0,)),
    "rad2deg": ([N], {}, (0,)),
    "gcd": ([ints(6, lo=1, hi=30), ints(6, lo=1, hi=30)], {}, ()),
    "lcm": ([ints(6, lo=1, hi=12), ints(6, lo=1, hi=12)], {}, ()),
    "heaviside": ([N, normal(3, 4)], {}, ()),
    "digamma": ([X], {}, (0,)),
    "lgamma": ([X], {}, (0,)),
    "conj": ([N], {}, (0,)),
    "real": ([N], {}, (0,)),
    "imag": ([N], {}, ()),
    "mv": ([N, normal(4)], {}, (0, 1)),
    "dist": ([N, normal(3, 4)], {"p": 3}, (0, 1)),
    "increment": ([N], {"value": 2.0}, (0,)),
    "unbind": ([N], {"axis": 1}, (0,)),
    "broadcast_tensors": ([lambda r: [normal(1, 4)(r), normal(3, 1)(r)]],
                          {}, ()),
    "multiplex": ([lambda r: [normal(3, 2)(r), normal(3, 2)(r)],
                   lambda r: np.array([[1], [0], [1]], np.int32)], {}, ()),
    "crop": ([N], {"shape": [2, -1], "offsets": [1, 1]}, (0,)),
    "squared_l2_norm": ([N], {}, (0,)),
    "cvm": ([f32(4, 5)], {"use_cvm": True}, (0,)),
    "fsp_matrix": ([normal(2, 3, 4, 4), normal(2, 5, 4, 4)], {}, (0, 1)),
    "partial_concat": ([lambda r: [normal(3, 5)(r), normal(3, 5)(r)]],
                       {"start_index": 1, "length": 2}, ()),
    "partial_sum": ([lambda r: [normal(3, 5)(r), normal(3, 5)(r)]],
                    {"start_index": -3}, ()),
}


def _args(name, wrap, grad):
    makers, kw, diff = CASES[name]
    r = np.random.RandomState(sum(map(ord, name)))
    raw = [m(r) for m in makers]
    args = []
    for i, a in enumerate(raw):
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            args.append([wrap(v) for v in a])
        else:
            args.append(wrap(a, grad and i in diff) if isinstance(
                a, np.ndarray) else a)
    return args, kw


def _call(pkg, name, wrap, grad=False):
    args, kw = _args(name, wrap, grad)
    fn = getattr(pkg, name, None) or getattr(pkg.ops, name)
    if wrap is port_t and name in ("full", "zeros", "ones", "empty",
                                   "arange", "linspace", "eye"):
        kw = dict(kw, device="cpu")
    return args, fn(*args, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    _, want = _call(paddle, name, ref_t)
    _, got = _call(pt, name, port_t)
    compare(want, got, what=name)
    leaves = got if isinstance(got, (list, tuple)) else [got]
    assert all(isinstance(v, pt.Tensor) for v in leaves
               if isinstance(v, torch.Tensor)), name


GRAD_CASES = sorted(n for n, (_, _, diff) in CASES.items() if diff)


def _seeded_loss(out, pkg):
    """sum(out * c) over every float output, c seeded by its shape."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    total = None
    for o in outs:
        if str(o.dtype).split(".")[-1] not in ("float32",):
            continue
        shape = list(o.shape)
        c = np.asarray(np.random.RandomState(len(shape) + 7).randn(*shape),
                       np.float32)
        term = (o * (paddle.to_tensor(c) if pkg is paddle else
                     pt.to_tensor(c, place="cpu"))).sum()
        total = term if total is None else total + term
    return total


@pytest.mark.parametrize("name", GRAD_CASES)
def test_op_gradient_matches_reference(name):
    grads = []
    for pkg, wrap in ((paddle, ref_t), (pt, port_t)):
        args, out = _call(pkg, name, wrap, grad=True)
        diff = CASES[name][2]
        ins = [args[i] for i in diff]
        loss = _seeded_loss(out, pkg)
        grads.append(pkg.grad([loss], ins, allow_unused=True))
    want, got = grads
    for i, (w, g) in enumerate(zip(want, got)):
        if w is None:
            assert g is None or not np.any(as_numpy(g)), (name, i)
            continue
        compare(w, g, rtol=1e-4, atol=1e-5, what=f"{name} d/dx{i}")


def test_setitem_matches_reference_and_keeps_the_graph():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    ref, port = paddle.to_tensor(a), pt.to_tensor(a, place="cpu")
    for idx, v in (((1, slice(None)), 7.0), ((slice(0, 2), 3), -1.0)):
        ref[idx] = v
        port[idx] = v
    compare(ref, port, what="setitem")
    x = pt.to_tensor(a, place="cpu", stop_gradient=False)
    y = x * 2
    y[0] = 0.0  # recorded: row 0's gradient is cut
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy()[0], 0.0)
    np.testing.assert_array_equal(x.grad.numpy()[1:], 2.0)


# -- random ops: shapes, dtypes and moments --------------------------------------

RANDOM = {
    "rand": (lambda f: f([4000]), "float32", 0.5, (1 / 12) ** 0.5),
    "randn": (lambda f: f([4000]), "float32", 0.0, 1.0),
    "normal": (lambda f: f(1.0, 2.0, [4000]), "float32", 1.0, 2.0),
    "uniform": (lambda f: f([4000], min=-2.0, max=2.0), "float32", 0.0,
                (16 / 12) ** 0.5),
    "randint": (lambda f: f(0, 10, [4000]), "int64", 4.5, (99 / 12) ** 0.5),
    "truncated_normal": (lambda f: f([4000]), "float32", 0.0, 0.8796),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_moments(name):
    call, dtype, mean, std = RANDOM[name]
    pt.seed(0)
    ref = np.asarray(call(getattr(paddle, name)).numpy())
    got = call(lambda *a, **k: getattr(pt, name)(*a, device="cpu", **k))
    assert isinstance(got, pt.Tensor) and got.shape == list(ref.shape)
    assert str(got.dtype) == f"torch.{dtype}"
    g = got.numpy().astype(np.float64)
    for arr in (ref.astype(np.float64), g):
        assert abs(arr.mean() - mean) < 0.1 * max(std, 1.0)
        assert abs(arr.std() - std) < 0.1 * std
    if name == "truncated_normal":
        assert np.abs(g).max() <= 2.0


def test_random_permutations_and_samplers():
    pt.seed(1)
    perm = pt.randperm(50, device="cpu").numpy()
    assert sorted(perm.tolist()) == list(range(50))
    x = pt.to_tensor(np.arange(20, dtype=np.float32).reshape(10, 2),
                     place="cpu")
    shuffled = pt.ops.shuffle(x).numpy()
    assert sorted(shuffled[:, 0].tolist()) == list(range(0, 20, 2))
    p = pt.to_tensor(np.full((2000,), 0.3, np.float32), place="cpu")
    b = pt.bernoulli(p).numpy()
    assert set(np.unique(b)) <= {0.0, 1.0} and abs(b.mean() - 0.3) < 0.05
    probs = pt.to_tensor(np.array([[0.0, 1.0, 0.0], [0.5, 0.0, 0.5]],
                                  np.float32), place="cpu")
    m = pt.multinomial(probs, 1).numpy()
    assert m[0, 0] == 1 and m[1, 0] in (0, 2)
    ref = paddle.multinomial(paddle.to_tensor(np.asarray(probs.numpy())), 1)
    assert np.asarray(ref.numpy()).shape == m.shape


def test_rng_state_round_trip_repeats_draws_bitwise():
    pt.seed(3)
    state = pt.get_rng_state(device="cpu")
    assert isinstance(state, pt.Tensor) and str(state.dtype) == "torch.uint8"
    first = [pt.rand([5], device="cpu").numpy(),
             pt.randn([2, 3], device="cpu").numpy(),
             pt.nn.functional.dropout(pt.to_tensor(np.ones((4, 4),
                                                           np.float32),
                                                   place="cpu"),
                                      p=0.5).numpy()]
    pt.set_rng_state(state, device="cpu")
    again = [pt.rand([5], device="cpu").numpy(),
             pt.randn([2, 3], device="cpu").numpy(),
             pt.nn.functional.dropout(pt.to_tensor(np.ones((4, 4),
                                                           np.float32),
                                                   place="cpu"),
                                      p=0.5).numpy()]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    # the reference's round trip repeats its draws the same way
    s = paddle.get_rng_state()
    r1 = np.asarray(paddle.rand([5]).numpy())
    paddle.set_rng_state(s)
    np.testing.assert_array_equal(np.asarray(paddle.rand([5]).numpy()), r1)


def test_ops_take_plain_tensors_and_return_tensor():
    out = pt.add(torch.ones(2), 1.0)
    assert type(out) is pt.Tensor and out.numpy().tolist() == [2.0, 2.0]
    assert type(pt.ops.matmul(torch.ones(2, 2), torch.ones(2))) is pt.Tensor


def test_data_norm_updates_its_summaries_like_the_reference():
    r = np.random.RandomState(5)
    x = r.rand(4, 3).astype(np.float32)
    size, s, sq = (np.full(3, 10.0, np.float32), r.rand(3).astype(np.float32),
                   (1 + r.rand(3)).astype(np.float32))
    ref = [paddle.to_tensor(v) for v in (size, s, sq)]
    port = [pt.to_tensor(v, place="cpu") for v in (size, s, sq)]
    want = paddle.data_norm(paddle.to_tensor(x), *ref)
    got = pt.data_norm(pt.to_tensor(x, place="cpu"), *port)
    compare(want, got, what="data_norm")
    for a, b in zip(ref, port):
        compare(a, b, what="data_norm summary")


HOST_DATA_CALLS = {
    "zeros_like": lambda a: pt.zeros_like(a),
    "ones_like": lambda a: pt.ones_like(a),
    "full_like": lambda a: pt.full_like(a, 2.0),
    "is_empty": lambda a: pt.is_empty(a),
    "sum": lambda a: pt.sum(a),
    "mean": lambda a: pt.mean(a),
    "cast": lambda a: pt.cast(a, "float32"),
    "cast_list": lambda a: pt.cast([1, 2], "float32"),
    "add_scalars": lambda a: pt.add(1.0, 2.0),
    "assign": lambda a: pt.assign(a),
    "bernoulli": lambda a: pt.bernoulli(np.full((2, 3), 0.5, np.float32)),
    "multinomial": lambda a: pt.multinomial(np.ones(4, np.float32), 2),
}


@pytest.mark.parametrize("name", sorted(HOST_DATA_CALLS))
def test_host_data_goes_to_the_card_or_raises(name):
    """An op given host data and no tensor to follow runs where the
    package's device rule says: on the card, and without one it raises
    (nothing drifts onto the CPU by itself)."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HOST_DATA_CALLS[name](a)
        return
    assert HOST_DATA_CALLS[name](a).place.type == "cuda"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_shape_follows_its_tensor(device):
    x = pt.Tensor(torch.empty(2, 3, device=device))
    out = pt.shape(x)
    assert out.place.type == device and out.dtype == torch.int64
    if device == "cpu":
        assert out.tolist() == [2, 3]
