"""dy2static on the CPU (``jit.dy2static``, ``to_static``'s AST fallback,
``not_to_static``, ``input_spec``), held against ``paddle_tpu``'s
``to_static`` on the same numpy inputs.

On the CPU a transformed function's control flow is data-dependent only
where it reads a recorded Program's variables, so each case records the
transformed function into a ``static.Program`` and replays it with feeds
that take other paths than the build's placeholders; results must equal
the eager function's and the reference's ``to_static``. The card's regime
(the fallback found by the warm-up's host read, then CUDA-graph IF and
WHILE nodes) is ``chip_smoke.py`` phase 22's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as static
from paddle_tpu_torch import jit
from paddle_tpu_torch.jit.dy2static import UNDEF, convert_to_static

CPU = "cpu"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _replay(fn, feeds, specs):
    """Record ``convert_to_static(fn)`` over placeholders of ``specs``
    ({name: (shape, dtype)}) and run it on each feed dict."""
    prog = static.Program()
    with static.program_guard(prog):
        args = [static.data(n, s, d, device=CPU) for n, (s, d) in
                specs.items()]
        out = convert_to_static(fn)(*args)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    exe = static.Executor(CPU)
    return prog, [exe.run(prog, feed=f, fetch_list=outs) for f in feeds]


def _branchy(x):
    if x.mean() > 0:
        y = x * 2.0
    else:
        y = x + 1.0
    return y.sum()


def _ref_branchy(x):
    if x.mean() > 0:
        y = x * 2.0
    else:
        y = x + 1.0
    return y.sum()


def test_data_dependent_if_replays_both_branches():
    xs = [np.random.RandomState(1).rand(2, 4).astype("float32") + 0.5,
          -np.random.RandomState(2).rand(2, 4).astype("float32") - 0.5]
    prog, got = _replay(_branchy, [{"x": x} for x in xs],
                        {"x": ([2, 4], "float32")})
    assert "conditional_block" in prog.op_names()
    static_ref = ref.jit.to_static(_ref_branchy)
    for x, (g,) in zip(xs, got):
        want = float(static_ref(ref.to_tensor(x)).numpy())
        assert float(g) == pytest.approx(want, rel=1e-6)
        assert float(g) == float(_branchy(torch.from_numpy(x)))


def _loop(x, n):
    acc = x * 0.0
    i = 0
    while i < n:
        acc = acc + x
        if acc.sum() > 2.5:
            break
        i = i + 1
    return acc.sum(), i


@pytest.mark.parametrize("n", [1, 5])
def test_while_with_a_traced_break(n):
    x = np.ones(1, np.float32)
    prog, got = _replay(_loop, [{"x": x, "n": np.int64(n)}],
                        {"x": ([1], "float32"), "n": ([], "int64")})
    assert "while" in prog.op_names()
    ev, ei = _loop(torch.from_numpy(x), torch.tensor(n))
    (gv, gi), = got
    assert float(gv) == float(ev) and int(gi) == int(ei)
    rv, ri = ref.jit.to_static(_loop)(ref.to_tensor(x), ref.to_tensor(n))
    assert float(gv) == float(rv.numpy()) and int(gi) == int(ri.numpy())


def _for_continue(x, n):
    acc = x * 0.0
    for i in range(n):
        if i % 2 == 1:
            continue
        acc = acc + x
    return acc.sum()


def test_for_range_over_a_tensor_bound_with_continue():
    x = np.ones(2, np.float32)
    _prog, got = _replay(_for_continue, [{"x": x, "n": np.int64(k)}
                                         for k in (6, 3)],
                         {"x": ([2], "float32"), "n": ([], "int64")})
    assert [float(g[0]) for g in got] == [6.0, 4.0]
    for k, (g,) in zip((6, 3), got):
        want = ref.jit.to_static(_for_continue)(ref.to_tensor(x),
                                                ref.to_tensor(k))
        assert float(g) == float(want.numpy())


_NET = {}  # the decode's layers, made by the test that runs it


def _greedy(h, n):
    cell, head, emb = _NET["cell"], _NET["head"], _NET["emb"]
    tokens = pt.zeros([2, 6], dtype="int64", device=CPU)
    tok = pt.zeros([2], dtype="int64", device=CPU)
    i = torch.zeros((), dtype=torch.int64)
    while i < n:
        h = torch.tanh(cell(h) + emb(tok))
        tok = torch.argmax(head(h), dim=-1)
        idx = torch.zeros((2, 1), dtype=torch.int64) + i
        tokens = torch.scatter(tokens, 1, idx, torch.reshape(tok, (2, 1)))
        i = i + 1
    return tokens, h


@pytest.fixture
def decode_net():
    torch.manual_seed(0)
    _NET.update(cell=pt.nn.Linear(8, 8, device=CPU),
                head=pt.nn.Linear(8, 12, device=CPU),
                emb=pt.nn.Embedding(12, 8, device=CPU))
    yield
    _NET.clear()


@pytest.mark.parametrize("n", [6, 3])
def test_greedy_decode_with_a_data_dependent_length(n, decode_net):
    """The seq2seq greedy decode (the reference's test_dy2static.py:174
    shape) with its length a feed: the replay's ids equal the eager
    decode's."""
    h0 = np.random.RandomState(11).rand(2, 8).astype(np.float32)
    with torch.no_grad():
        prog, got = _replay(_greedy, [{"h": h0, "n": np.int64(n)}],
                            {"h": ([2, 8], "float32"), "n": ([], "int64")})
        want_tokens, want_h = _greedy(torch.from_numpy(h0), torch.tensor(n))
    assert "while" in prog.op_names()
    (tokens, h), = got
    np.testing.assert_array_equal(tokens, want_tokens.numpy())
    np.testing.assert_allclose(h, want_h.numpy(), rtol=1e-6)


def test_transformed_functions_keep_python_semantics():
    def f(a, flag):
        if flag:
            b = a + 1
        else:
            b = a - 1
        n = 0
        while n < 3:
            b = b * 2
            n += 1
        return b, (flag and n) or -1

    def g(n):
        total = 0
        for i in range(n):
            if i == 2:
                continue
            if i == 5:
                break
            total += i
        return total, i

    cf, cg = convert_to_static(f), convert_to_static(g)
    assert cf(1, True) == f(1, True) and cf(1, False) == f(1, False)
    assert cg(8) == g(8) == (1 + 3 + 4, 5) and cg(2) == g(2)
    with pytest.raises(NameError):
        bool(UNDEF)


def test_not_to_static_callee_is_left_alone():
    @jit.not_to_static
    def helper(x):
        return x * 3

    def f(x):
        return helper(x) + 1
    conv = convert_to_static(f)
    assert helper._not_to_static
    from paddle_tpu_torch.jit.dy2static import _convert_callee
    assert _convert_callee(helper) is helper
    assert float(conv(torch.tensor(2.0))) == 7.0


def test_fallback_swaps_in_the_transformed_function():
    """The fallback the warm-up triggers on the card: the program's
    function becomes its transformed form (and counts it); a lambda
    cannot be transformed and raises, naming the fallback."""
    from paddle_tpu_torch.observability import tracing
    sf = jit.to_static(_branchy, input_spec=[jit.InputSpec([2, 4])])
    assert sf._input_spec[0].shape == (2, 4)
    before = tracing.counter_value("jit_ast_fallbacks") if hasattr(
        tracing, "counter_value") else None
    sf._try_ast_fallback()
    assert getattr(sf._fn, "_jst_transformed", False)
    x = torch.ones(2, 4)
    assert float(sf(x)) == float(_branchy(x))
    if before is not None:
        assert tracing.counter_value("jit_ast_fallbacks") == before + 1
    lam = jit.to_static(lambda t: t * 2)
    with pytest.raises(RuntimeError, match="AST fallback"):
        lam._try_ast_fallback()
