"""The port's ``Tensor`` and ``Parameter`` (``paddle_tpu_torch.core.tensor``)
against the reference's, on the CPU.

- Every ``Tensor`` name of ``API.spec`` is called on seeded inputs in both
  packages and must give the reference's result (float32 within
  ``RTOL``/``ATOL``, the rest exactly; the dtype's kind alike).
- Every ``Parameter`` name: those torch does not define carry the
  reference's meaning (the same check); those torch defines keep torch's
  (they are torch's own methods), and each whose meaning differs from the
  reference's is in ``core.tensor``'s table of deliberate differences
  and has its case in ``PARAMETER_DIFFERENCES`` here.
- The dunders, ``__getitem__``/``__setitem__``, the boundary of a
  ``Layer`` call, and the deliberate differences of ``Tensor`` itself.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from test_torch_ops import compare

RTOL, ATOL = 1e-5, 1e-6

SPEC = [line.split()[0] for line in open(
    __file__.rsplit("/", 2)[0] + "/API.spec").read().splitlines()
    if line.strip() and not line.startswith("#")]
TENSOR_NAMES = sorted(n.split(".")[-1] for n in SPEC
                      if n.startswith("paddle_tpu.Tensor."))
PARAMETER_NAMES = sorted(n.split(".")[-1] for n in SPEC
                         if n.startswith("paddle_tpu.Parameter."))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs():
    r = np.random.RandomState(11)
    return {"x": (0.1 + 0.8 * r.rand(3, 4)).astype(np.float32),
            "y": r.randn(3, 4).astype(np.float32),
            "m": r.randn(4, 2).astype(np.float32),
            "sq": r.randn(3, 3).astype(np.float32),
            "v": r.randn(4).astype(np.float32),
            "i": r.randint(1, 20, (3, 4)).astype(np.int64),
            "c3": r.randn(3, 3).astype(np.float32)}


def _pkg(which):
    if which == "ref":
        return paddle, lambda a, grad=False: paddle.to_tensor(
            a, stop_gradient=not grad)
    return pt, lambda a, grad=False: pt.to_tensor(a, place="cpu",
                                                  stop_gradient=not grad)


# name: fn(T, d) -> result; T makes a tensor of the package, d the inputs
METHODS = {
    "T": lambda T, d: T(d["y"]).T,
    "abs": lambda T, d: T(d["y"]).abs(),
    "acos": lambda T, d: T(d["x"]).acos(),
    "add": lambda T, d: T(d["x"]).add(T(d["y"])),
    "add_": lambda T, d: T(d["x"]).add_(T(d["y"])),
    "all": lambda T, d: (T(d["i"]) > 3).all(axis=1),
    "allclose": lambda T, d: T(d["x"]).allclose(T(d["x"])),
    "any": lambda T, d: (T(d["i"]) > 18).any(),
    "argmax": lambda T, d: T(d["y"]).argmax(axis=1),
    "argmin": lambda T, d: T(d["y"]).argmin(),
    "argsort": lambda T, d: T(d["y"]).argsort(axis=0),
    "asin": lambda T, d: T(d["x"]).asin(),
    "astype": lambda T, d: T(d["y"]).astype("int32"),
    "atan": lambda T, d: T(d["y"]).atan(),
    "backward": None,  # the autograd cases below
    "bincount": lambda T, d: T(d["i"]).reshape([-1]).bincount(),
    "block_until_ready": lambda T, d: T(d["y"]).block_until_ready(),
    "bmm": lambda T, d: T(d["y"].reshape(1, 3, 4)).bmm(
        T(d["m"].reshape(1, 4, 2))),
    "broadcast_to": lambda T, d: T(d["v"]).broadcast_to([3, 4]),
    "cast": lambda T, d: T(d["y"]).cast("float64"),
    "ceil": lambda T, d: T(d["y"]).ceil(),
    "chunk": lambda T, d: T(d["y"]).chunk(2, axis=1),
    "clear_grad": None,
    "clear_gradient": None,
    "clip": lambda T, d: T(d["y"]).clip(-0.3, 0.4),
    "clip_": lambda T, d: T(d["y"]).clip_(-0.3, 0.4),
    "clone": lambda T, d: T(d["y"]).clone(),
    "conj": lambda T, d: T(d["y"]).conj(),
    "copy_": lambda T, d: T(d["y"]).copy_(T(d["x"])),
    "cos": lambda T, d: T(d["y"]).cos(),
    "cosh": lambda T, d: T(d["y"]).cosh(),
    "cross": lambda T, d: T(d["c3"]).cross(T(d["sq"])),
    "cumprod": lambda T, d: T(d["x"]).cumprod(dim=1),
    "cumsum": lambda T, d: T(d["y"]).cumsum(),
    "deg2rad": lambda T, d: T(d["y"]).deg2rad(),
    "detach": lambda T, d: T(d["y"]).detach(),
    "diagonal": lambda T, d: T(d["sq"]).diagonal(offset=1),
    "diff": lambda T, d: T(d["y"]).diff(axis=0),
    "digamma": lambda T, d: T(d["x"]).digamma(),
    "dist": lambda T, d: T(d["x"]).dist(T(d["y"]), p=1),
    "divide": lambda T, d: T(d["y"]).divide(T(d["x"])),
    "dot": lambda T, d: T(d["v"]).dot(T(d["v"])),
    "dtype": lambda T, d: str(T(d["y"]).dtype).split(".")[-1],
    "equal_all": lambda T, d: T(d["i"]).equal_all(T(d["i"])),
    "erf": lambda T, d: T(d["y"]).erf(),
    "exp": lambda T, d: T(d["y"]).exp(),
    "expand": lambda T, d: T(d["v"]).expand([2, 4]),
    "expand_as": lambda T, d: T(d["v"]).expand_as(T(d["y"])),
    "fill_": lambda T, d: T(d["y"]).fill_(2.5),
    "flatten": lambda T, d: T(d["y"].reshape(3, 2, 2)).flatten(1),
    "flip": lambda T, d: T(d["y"]).flip([1]),
    "floor": lambda T, d: T(d["y"]).floor(),
    "frac": lambda T, d: T(d["y"]).frac(),
    "gather": lambda T, d: T(d["y"]).gather(T(np.array([2, 0])), axis=0),
    "gather_nd": lambda T, d: T(d["y"]).gather_nd(T(np.array([[1, 2]]))),
    "gcd": lambda T, d: T(d["i"]).gcd(T(d["i"] + 3)),
    "grad": None,
    "heaviside": lambda T, d: T(d["y"]).heaviside(T(d["x"])),
    "histogram": lambda T, d: T(d["y"]).histogram(bins=4),
    "imag": lambda T, d: T(d["y"]).imag(),
    "increment": lambda T, d: T(d["y"]).increment(3.0),
    "index_select": lambda T, d: T(d["y"]).index_select(
        T(np.array([3, 1])), axis=1),
    "is_leaf": None,
    "isfinite": lambda T, d: T(d["y"]).isfinite(),
    "isinf": lambda T, d: T(d["y"]).isinf(),
    "isnan": lambda T, d: T(d["y"]).isnan(),
    "item": lambda T, d: T(d["y"])[1, 2].item(),
    "kron": lambda T, d: T(d["sq"]).kron(T(d["c3"])),
    "kthvalue": lambda T, d: T(d["y"]).kthvalue(2),
    "lcm": lambda T, d: T(d["i"]).lcm(T(d["i"] + 1)),
    "lerp": lambda T, d: T(d["x"]).lerp(T(d["y"]), 0.3),
    "lgamma": lambda T, d: T(d["x"]).lgamma(),
    "log": lambda T, d: T(d["x"]).log(),
    "log10": lambda T, d: T(d["x"]).log10(),
    "log1p": lambda T, d: T(d["x"]).log1p(),
    "log2": lambda T, d: T(d["x"]).log2(),
    "logsumexp": lambda T, d: T(d["y"]).logsumexp(axis=1),
    "masked_fill": lambda T, d: T(d["y"]).masked_fill(T(d["i"] > 9), -1.0),
    "masked_select": lambda T, d: T(d["y"]).masked_select(T(d["i"] > 9)),
    "matmul": lambda T, d: T(d["y"]).matmul(T(d["m"])),
    "max": lambda T, d: T(d["y"]).max(axis=1),
    "maximum": lambda T, d: T(d["y"]).maximum(T(d["x"])),
    "mean": lambda T, d: T(d["y"]).mean(axis=0, keepdim=True),
    "median": lambda T, d: T(d["y"]).median(axis=1),
    "min": lambda T, d: T(d["y"]).min(),
    "minimum": lambda T, d: T(d["y"]).minimum(T(d["x"])),
    "mm": lambda T, d: T(d["y"]).mm(T(d["m"])),
    "mod": lambda T, d: T(d["y"]).mod(T(d["x"])),
    "mode": lambda T, d: T(d["i"] % 4).mode(axis=1),
    "moveaxis": lambda T, d: T(d["y"]).moveaxis(0, 1),
    "multiply": lambda T, d: T(d["y"]).multiply(T(d["x"])),
    "multiply_": lambda T, d: T(d["y"]).multiply_(T(d["x"])),
    "mv": lambda T, d: T(d["y"]).mv(T(d["v"])),
    "nanmean": lambda T, d: T(d["y"]).nanmean(axis=1),
    "nanmedian": lambda T, d: T(d["y"]).nanmedian(),
    "nansum": lambda T, d: T(d["y"]).nansum(),
    "ndim": lambda T, d: T(d["y"]).ndim,
    "norm": lambda T, d: T(d["y"]).norm(p=1, axis=0),
    "numel": lambda T, d: T(d["y"]).numel(),
    "numpy": lambda T, d: T(d["y"]).numpy(),
    "outer": lambda T, d: T(d["v"]).outer(T(d["v"])),
    "place": None,  # a deliberate difference (below)
    "pow": lambda T, d: T(d["x"]).pow(2.5),
    "prod": lambda T, d: T(d["x"]).prod(axis=0),
    "put_along_axis": lambda T, d: T(d["y"]).put_along_axis(
        T(np.array([[0], [3], [1]])), T(np.ones((3, 1), np.float32)), 1),
    "quantile": lambda T, d: T(d["y"]).quantile(0.3, axis=1),
    "rad2deg": lambda T, d: T(d["y"]).rad2deg(),
    "real": lambda T, d: T(d["y"]).real(),
    "reciprocal": lambda T, d: T(d["x"]).reciprocal(),
    "repeat_interleave": lambda T, d: T(d["y"]).repeat_interleave(2, axis=0),
    "reshape": lambda T, d: T(d["y"]).reshape([2, 6]),
    "retain_grads": None,
    "roll": lambda T, d: T(d["y"]).roll(2, axis=1),
    "rot90": lambda T, d: T(d["y"]).rot90(),
    "round": lambda T, d: T(d["y"] * 3).round(),
    "rsqrt": lambda T, d: T(d["x"]).rsqrt(),
    "scale": lambda T, d: T(d["y"]).scale(2.0, 1.0),
    "scale_": lambda T, d: T(d["y"]).scale_(2.0, 1.0),
    "set_value": None,
    "shape": lambda T, d: T(d["y"]).shape,
    "sign": lambda T, d: T(d["y"]).sign(),
    "sin": lambda T, d: T(d["y"]).sin(),
    "sinh": lambda T, d: T(d["y"]).sinh(),
    "size": lambda T, d: T(d["y"]).size,
    "slice": lambda T, d: T(d["y"]).slice([1], [1], [3]),
    "sort": lambda T, d: T(d["y"]).sort(axis=0, descending=True),
    "split": lambda T, d: T(d["y"]).split([1, 3], axis=1),
    "sqrt": lambda T, d: T(d["x"]).sqrt(),
    "square": lambda T, d: T(d["y"]).square(),
    "squeeze": lambda T, d: T(d["y"].reshape(3, 1, 4)).squeeze(1),
    "std": lambda T, d: T(d["y"]).std(axis=1),
    "strided_slice": lambda T, d: T(d["y"]).strided_slice(
        [1], [3], [0], [-2]),
    "subtract": lambda T, d: T(d["y"]).subtract(T(d["x"])),
    "subtract_": lambda T, d: T(d["y"]).subtract_(T(d["x"])),
    "sum": lambda T, d: T(d["y"]).sum(axis=[0, 1]),
    "t": lambda T, d: T(d["y"]).t(),
    "take_along_axis": lambda T, d: T(d["y"]).take_along_axis(
        T(np.array([[0], [3], [1]])), 1),
    "tan": lambda T, d: T(d["y"]).tan(),
    "tanh": lambda T, d: T(d["y"]).tanh(),
    "tile": lambda T, d: T(d["v"]).tile([2, 1]),
    "tolist": lambda T, d: T(d["i"]).tolist(),
    "topk": lambda T, d: T(d["y"]).topk(2, axis=0, largest=False),
    "trace": lambda T, d: T(d["sq"]).trace(),
    "transpose": lambda T, d: T(d["y"]).transpose([1, 0]),
    "trunc": lambda T, d: T(d["y"] * 3).trunc(),
    "unbind": lambda T, d: T(d["y"]).unbind(axis=1),
    "unique": lambda T, d: T(d["i"]).unique(return_counts=True),
    "unique_consecutive": lambda T, d: T(
        np.array([3, 3, 1, 1, 1, 3])).unique_consecutive(return_counts=True),
    "unsqueeze": lambda T, d: T(d["y"]).unsqueeze([0, 2]),
    "unstack": lambda T, d: T(d["y"]).unstack(axis=0),
    "var": lambda T, d: T(d["y"]).var(axis=0, unbiased=False),
    "zero_": lambda T, d: T(d["y"]).zero_(),
}


def _autograd_case(name, pkg, T, d):
    """The names about gradients, each as a comparable result."""
    x = T(d["x"], grad=True)
    if name == "backward":
        (x * x).backward()  # non-scalar: seeded with ones
        return x.grad
    if name == "grad":
        (x * 3).sum().backward()
        return x.grad, x.grad.stop_gradient
    if name in ("clear_grad", "clear_gradient"):
        (x * 3).sum().backward()
        getattr(x, name)()
        return x.grad is None
    if name == "is_leaf":
        return x.is_leaf, (x * 2).is_leaf
    if name == "retain_grads":
        h = x * 2
        h.retain_grads()
        (h * h).sum().backward()
        return h.grad
    if name == "set_value":
        t = T(d["y"])
        t.set_value(d["x"])
        return t
    raise KeyError(name)


def _run(name, which):
    pkg, T = _pkg(which)
    d = _inputs()
    fn = METHODS[name]
    if fn is None:
        return _autograd_case(name, pkg, T, d)
    return fn(T, d)


def _plain(v):
    if isinstance(v, (list, tuple)) and not (
            v and all(isinstance(e, (int, float, list)) for e in v)):
        return [_plain(e) for e in v]
    if isinstance(v, torch.Tensor):
        v = v.detach()
    if hasattr(v, "numpy"):
        return np.asarray(v.numpy())
    return np.asarray(v)


CALLED = sorted(n for n in TENSOR_NAMES if n != "place")


def test_the_table_covers_every_tensor_name():
    assert set(METHODS) == set(TENSOR_NAMES) and len(TENSOR_NAMES) == 152


@pytest.mark.parametrize("name", CALLED)
def test_tensor_name_matches_reference(name):
    want, got = _run(name, "ref"), _run(name, "port")
    if isinstance(got, torch.Tensor):
        assert type(got) is pt.Tensor, name
    compare(_plain(want), _plain(got), rtol=RTOL, atol=ATOL, what=name)


# -- Parameter --------------------------------------------------------------------

# The names whose torch meaning, kept on a Parameter, differs from the
# reference's: name -> a check of the difference on the same values.
def _p():
    return pt.Parameter(torch.from_numpy(_inputs()["y"]))


def _rp():
    return paddle.Parameter(_inputs()["y"])


PARAMETER_DIFFERENCES = {
    "shape": lambda: (isinstance(_p().shape, torch.Size)
                      and list(_p().shape) == _rp().shape),
    "size": lambda: _p().size() == torch.Size([3, 4]) and _rp().size == 12,
    "grad": lambda: _grad_kept(),
    "numel": lambda: _p().numel() == 12 and int(_rp().numel()) == 12,
    "allclose": lambda: _p().allclose(_p()) is True,
    "split": lambda: [tuple(s.shape) for s in _p().split(1, dim=1)] == [
        (3, 1)] * 4 and [s.shape for s in _rp().split(2, axis=1)] == [
        [3, 2]] * 2,
    "transpose": lambda: tuple(_p().transpose(0, 1).shape) == (4, 3),
    "t": lambda: tuple(_p().t().shape) == (4, 3),
    "unsqueeze": lambda: tuple(_p().unsqueeze(0).shape) == (1, 3, 4),
    "max": lambda: _pair_of(_p().max(dim=1)),
    "min": lambda: _pair_of(_p().min(dim=1)),
    "median": lambda: _pair_of(_p().median(dim=1)),
    "nanmedian": lambda: _pair_of(_p().nanmedian(dim=1)),
    "mode": lambda: _pair_of(_p().mode(dim=1)),
    "kthvalue": lambda: _pair_of(_p().kthvalue(2, dim=1)),
    "sort": lambda: _pair_of(_p().sort(dim=1)),
    "gather": lambda: tuple(_p().gather(1, torch.zeros(3, 1, dtype=torch.long))
                            .shape) == (3, 1),
    "index_select": lambda: tuple(_p().index_select(
        1, torch.tensor([0])).shape) == (3, 1),
    "unique": lambda: _p().unique(sorted=True).numel() == 12,
    "unique_consecutive": lambda: _p().unique_consecutive(dim=0).shape[0]
    == 3,
    "cumsum": lambda: _raises(lambda: _p().cumsum()),
    "logsumexp": lambda: _raises(lambda: _p().logsumexp()),
    "histogram": lambda: len(_p().detach().histogram(4)) == 2,
    "real": lambda: not callable(_p().real),
    "imag": lambda: _raises(lambda: _p().imag),
    "numpy": lambda: _raises(lambda: _p().numpy()),
    "norm": lambda: _p().norm(dim=0).shape == (4,),
    "backward": lambda: _raises(lambda: _p().backward()),
    "flatten": lambda: _p().flatten(0, 1).shape == (12,),
    "reshape": lambda: _p().reshape(4, 3).shape == (4, 3),
    "expand": lambda: _p()[:1].expand(2, 4).shape == (2, 4),
    "squeeze": lambda: _p().squeeze(0).shape == (3, 4),
    "dtype": lambda: _p().dtype is torch.float32,
    "T": lambda: tuple(_p().T.shape) == (4, 3),
}


def _raises(fn):
    try:
        fn()
    except (RuntimeError, TypeError, ValueError):
        return True
    return False


def _pair_of(res):
    return isinstance(res, tuple) and len(res) == 2


def _grad_kept():
    p = _p()
    (p * 2).sum().backward()
    return type(p.grad) is torch.Tensor


def _torch_names():
    return sorted(n for n in PARAMETER_NAMES if hasattr(torch.Tensor, n))


@pytest.mark.parametrize("name", sorted(n for n in PARAMETER_NAMES
                                        if not hasattr(torch.Tensor, n)))
def test_parameter_name_torch_lacks_has_the_reference_meaning(name):
    if name in ("place",):
        assert _p().place == torch.device("cpu")
        return
    if name in ("trainable", "clear_grad", "clear_gradient",
                "retain_grads", "set_value", "block_until_ready"):
        p, rp = _p(), _rp()
        if name == "trainable":
            p.trainable, rp.trainable = False, False
            assert p.stop_gradient and rp.stop_gradient
            return
        if name == "set_value":
            p.set_value(np.ones((3, 4), np.float32))
            rp.set_value(np.ones((3, 4), np.float32))
            compare(rp, p)
            return
        if name.startswith("clear"):
            (p * 2).sum().backward()
            getattr(p, name)()
            assert p.grad is None
            return
        assert getattr(p, name)() is p or name == "retain_grads"
        return
    d = _inputs()
    want = METHODS[name](lambda a, grad=False: paddle.Parameter(a), d)
    if name.endswith("_"):  # in place on a leaf that requires grad: torch's
        with pytest.raises(RuntimeError, match="in-place"):  # rule
            METHODS[name](lambda a, grad=False: pt.Parameter(
                torch.from_numpy(np.asarray(a))), d)
        with pt.no_grad():
            got = METHODS[name](lambda a, grad=False: pt.Parameter(
                torch.from_numpy(np.asarray(a))), d)
        compare(_plain(want), _plain(got), what=name)
        return
    got = METHODS[name](
        lambda a, grad=False: pt.Parameter(torch.from_numpy(np.asarray(a))),
        d)
    compare(_plain(want), _plain(got), what=name)


@pytest.mark.parametrize("name", _torch_names())
def test_parameter_keeps_torch_meaning(name):
    """torch's own attribute; where its meaning differs from the
    reference's, the difference is stated and checked."""
    own = getattr(torch.Tensor, name)
    mine = getattr(pt.Parameter, name)
    assert mine is own or getattr(pt.Parameter, name) == own or (
        name in ("grad",)), name
    if name in PARAMETER_DIFFERENCES:
        assert PARAMETER_DIFFERENCES[name](), name


def test_parameter_difference_table_is_the_documented_one():
    doc = pt.core.tensor.__doc__.replace("\n", " ")
    for name in PARAMETER_DIFFERENCES:
        assert f"``{name}``" in doc or name in ("T", "dtype"), name


# -- Tensor itself ------------------------------------------------------------------

def test_tensor_deliberate_differences():
    x = pt.to_tensor(np.ones((2, 3), np.float32), place="cpu",
                     stop_gradient=False)
    assert x.dtype is pt.float32 is torch.float32          # a torch.dtype
    assert x.place == torch.device("cpu")                  # a torch.device
    b = pt.to_tensor(np.array([1.5, 2.25], np.float32), dtype="bfloat16",
                     place="cpu")
    assert b.numpy().dtype == np.float32                   # widened exactly
    np.testing.assert_array_equal(b.numpy(), [1.5, 2.25])
    h = x * 2
    with pytest.raises(RuntimeError, match="detach"):
        h.stop_gradient = True                             # not a leaf
    with pytest.raises(RuntimeError):
        x.add_(1.0)                                        # a leaf with grad
    assert pt.to_tensor(np.ones(2), place="cpu").dtype == torch.float64
    assert pt.to_tensor([1.5], place="cpu").dtype == torch.float32
    assert pt.to_tensor([1, 2], place="cpu").dtype == torch.int64


def test_dunders_match_reference():
    d = _inputs()
    for pkg, T in (_pkg("ref"), _pkg("port")):
        a, b = T(d["y"]), T(d["x"])
        res = [a + b, a - 1.5, 2.0 * a, a / b, a ** 2, -a, abs(a), a @ T(
            d["m"]), a > b, a <= 0.0, a == a, ~(a > 0), 3.0 - a, 1.0 / b]
        if pkg is paddle:
            want = res
        else:
            got = res
            assert all(type(v) is pt.Tensor for v in got)
    for i, (w, g) in enumerate(zip(want, got)):
        compare(w, g, what=f"dunder {i}")
    t = pt.to_tensor(d["y"], place="cpu")
    assert len(t) == 3 and hash(t) == id(t) and [r.shape for r in t] == [
        [4]] * 3
    assert "Tensor(shape=[3, 4], dtype=float32" in repr(t)


@pytest.mark.parametrize("idx", [
    1, (slice(None), 2), (slice(0, 2), [0, 3]), (Ellipsis, -1),
    (np.array([True, False, True]),), (None, 1)])
def test_getitem_setitem_match_reference(idx):
    d = _inputs()
    want = paddle.to_tensor(d["y"])[idx]
    got = pt.to_tensor(d["y"], place="cpu")[idx]
    compare(want, got, what=f"getitem {idx!r}")
    ref, port = paddle.to_tensor(d["y"]), pt.to_tensor(d["y"], place="cpu")
    ref[idx] = 5.0
    port[idx] = 5.0
    compare(ref, port, what=f"setitem {idx!r}")


def test_getitem_is_differentiable_and_a_view():
    x = pt.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                     place="cpu", stop_gradient=False)
    x[1, 1:].sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [[0, 0, 0], [0, 1, 1]])
    y = pt.to_tensor(np.zeros((2, 3), np.float32), place="cpu")
    row = y[0]
    row.fill_(4.0)
    assert y.numpy()[0].tolist() == [4.0] * 3


def test_layer_call_boundary():
    lin = pt.nn.Linear(4, 2, device="cpu")
    x = pt.to_tensor(_inputs()["y"], place="cpu")
    out = lin(x)
    assert type(out) is pt.Tensor and out.shape == [3, 2]
    plain = lin(torch.from_numpy(_inputs()["y"]))
    assert type(plain) is torch.Tensor and torch.equal(plain, out.detach())
    seen = []
    lin.register_forward_pre_hook(lambda m, a: seen.append(type(a[0])))
    lin(x)
    assert seen == [torch.Tensor]                  # forward sees plain
    assert type(pt.nn.functional.relu(x)) is pt.Tensor
    assert type(pt.nn.functional.relu(torch.ones(2))) is torch.Tensor
    assert isinstance(lin.weight, pt.Parameter)
    assert isinstance(lin.weight, pt.Tensor)       # as in the reference
    assert not issubclass(pt.Parameter, pt.Tensor)


def test_parameter_copies_keep_type_and_attributes():
    lin = pt.nn.Linear(2, 2, weight_attr=pt.ParamAttr(
        name="w0", learning_rate=0.5), device="cpu")
    for other in (copy.deepcopy(lin), pickle.loads(pickle.dumps(lin))):
        w = other.weight
        assert type(w) is pt.Parameter and w.param_name == "w0"
        assert w.optimize_attr == {"learning_rate": 0.5}
        assert torch.equal(w, lin.weight) and w is not lin.weight


def test_parameters_register_in_the_state_registry():
    from paddle_tpu_torch.core import state
    p = pt.Parameter(torch.ones(3))
    uid = p._state_uid
    assert any(t is p for _, t in state.snapshot())
    del p
    import gc
    gc.collect()
    assert all(u != uid for u, _ in state.snapshot())


def test_inference_tensor_is_the_tensor():
    assert pt.inference.Tensor is pt.Tensor


def test_to_static_takes_tensor_inputs():
    lin = pt.nn.Linear(4, 2, device="cpu")
    opt = pt.optimizer.SGD(0.1, parameters=lin.parameters())

    def step(x):
        loss = lin(x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    prog = pt.jit.to_static(step, scan_steps=2)
    xs = pt.to_tensor(np.random.RandomState(0).randn(2, 3, 4)
                      .astype(np.float32), place="cpu")
    out = prog(xs)
    assert type(out) is pt.Tensor and out.shape == [2]
