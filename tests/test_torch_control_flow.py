"""Control flow on the CPU (``nn.control_flow``): ``cond``, ``case``,
``switch_case``, ``while_loop`` and the TensorArray ops, eagerly and
recorded into a ``static.Program``, held against ``paddle_tpu``'s (the
reference's eager calls, its ``to_static`` and its Programs) on the same
numpy inputs; float32 to 1e-5 relative.

On the CPU a recorded construct replays as Python over its recorded
branches, with a bounded loop's trip bound and NaN poisoning. The
captured regime (CUDA-graph IF and WHILE nodes, the gradient of the
taken branch through the IF chain's backward) runs on the card only:
``chip_smoke.py`` phase 22 holds it against eager and CPU runs.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn as rnn
import paddle_tpu.static as rstatic
from paddle_tpu.core.tensor import Tensor as RefTensor
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.static as static

CPU = "cpu"
REL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def t(x, grad=False, dtype=None):
    v = torch.as_tensor(np.asarray(x))
    if dtype is not None:
        v = v.to(getattr(torch, dtype))
    return v.requires_grad_(grad)


def rt(x, grad=False, dtype=None):
    return RefTensor(np.asarray(x), dtype=dtype, stop_gradient=not grad)


# -- eager ---------------------------------------------------------------------

def test_eager_cond_and_grad_match_the_reference():
    x, rx = t([1.0, 2.0], grad=True), rt([1.0, 2.0], grad=True)
    for flag in (True, False):
        out = nn.cond(t(flag), lambda: x * 2, lambda: x * 3)
        want = rnn.cond(rt(flag), lambda: rx * 2, lambda: rx * 3)
        np.testing.assert_array_equal(out.detach().numpy(), want.numpy())
    out = nn.cond(t(True), lambda: (x * x).sum(), lambda: x.sum())
    out.backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 4.0])
    assert nn.cond(False, lambda: 1, lambda: 2) == 2


def test_eager_while_and_grad():
    i, s = nn.while_loop(lambda i, s: i < 5, lambda i, s: [i + 1, s + i],
                         [t(0), t(0)])
    assert int(i) == 5 and int(s) == 10
    w = t([0.5], grad=True)
    _, acc = nn.while_loop(lambda i, a: i < 3, lambda i, a: [i + 1, a * w],
                           [t(0), t([1.0])])
    acc.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), [3 * 0.5 ** 2], rtol=REL)
    with pytest.raises(ValueError):
        nn.while_loop(lambda: True, lambda: [], [])


@pytest.mark.parametrize("flags", [(False, True, True), (False, False, True),
                                   (False, False, False)])
def test_eager_case_matches_the_reference(flags):
    fns = [lambda: t(1.0), lambda: t(2.0), lambda: t(3.0)]
    rfns = [lambda: rt(1.0), lambda: rt(2.0), lambda: rt(3.0)]
    got = nn.case([(t(f), fn) for f, fn in zip(flags, fns)],
                  default=lambda: t(-1.0))
    want = rnn.case([(rt(f), fn) for f, fn in zip(flags, rfns)],
                    default=lambda: rt(-1.0))
    assert float(got) == float(want.numpy())


@pytest.mark.parametrize("index", [0, 2, 5])
def test_eager_switch_case_matches_the_reference(index):
    got = nn.switch_case(t(index), {0: lambda: t(10.0), 2: lambda: t(20.0)},
                         default=lambda: t(-1.0))
    want = rnn.switch_case(rt(index), {0: lambda: rt(10.0),
                                       2: lambda: rt(20.0)},
                           default=lambda: rt(-1.0))
    assert float(got) == float(want.numpy())
    # default None: the highest key's branch
    assert float(nn.switch_case(t(7), [lambda: t(1.0), lambda: t(2.0)])) == 2


def test_tensor_array():
    arr = nn.create_array()
    nn.array_write(t([1.0]), t(0), arr)
    nn.array_write(t([2.0]), t(1), arr)
    assert int(nn.array_length(arr)) == 2
    np.testing.assert_array_equal(nn.array_read(arr, t(1)).numpy(), [2.0])
    nn.array_write(t([5.0]), t(0), arr)
    np.testing.assert_array_equal(nn.array_read(arr, t(0)).numpy(), [5.0])
    with pytest.raises(IndexError):
        nn.array_write(t([1.0]), t(5), arr)


# -- recorded into a Program, against the reference's to_static and Programs ---

def _exe(st):
    return st.Executor(CPU) if st is static else st.Executor()


def _data(st, name, shape, dtype):
    if st is static:
        return st.data(name, shape, dtype, device=CPU)
    return st.data(name, shape, dtype)


@pytest.mark.parametrize("feed", [[1.0, 2.0], [-1.0, -2.0]])
def test_cond_in_program(feed):
    outs = []
    for st, mod in ((static, nn), (rstatic, rnn)):
        prog = st.Program()
        with st.program_guard(prog):
            x = _data(st, "x", [2], "float32")
            out = mod.cond(x.sum() > 0, lambda: x * 2, lambda: x * -1)
            same = mod.cond(x.sum() > 0, lambda: x, lambda: x * -1)
        outs.append(_exe(st).run(prog, feed={"x": np.array(feed, np.float32)},
                                 fetch_list=[out, same]))
    assert "conditional_block" in prog.op_names()
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [5, 7])
def test_while_in_program(n):
    outs = []
    for pkg, st, mod in ((pt, static, nn), (ref, rstatic, rnn)):
        prog = st.Program()
        with st.program_guard(prog):
            nn_ = _data(st, "n", [], "int32")
            kw = {"device": CPU} if st is static else {}
            i = pkg.zeros([], dtype="int32", **kw)
            s = pkg.zeros([], dtype="float32", **kw)
            with pkg.no_grad():
                _, s2 = mod.while_loop(
                    lambda i, s: i < nn_,
                    lambda i, s: [i + 1, s + pkg.cast(i, "float32")], [i, s])
        outs.append(_exe(st).run(prog, feed={"n": np.int32(n)},
                                 fetch_list=[s2])[0])
    assert float(outs[0]) == float(outs[1]) == n * (n - 1) / 2


@pytest.mark.parametrize("idx", [1, 9])
def test_switch_case_in_program(idx):
    outs = []
    for st, mod in ((static, nn), (rstatic, rnn)):
        prog = st.Program()
        with st.program_guard(prog):
            i = _data(st, "idx", [], "int32")
            x = _data(st, "x", [2], "float32")
            out = mod.switch_case(i, {0: lambda: x + 10, 1: lambda: x * 5},
                                  default=lambda: x - 1)
        outs.append(_exe(st).run(prog, feed={
            "idx": np.int32(idx), "x": np.array([1., 2.], np.float32)},
            fetch_list=[out])[0])
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("flags", [(1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)])
def test_case_in_program(flags):
    outs = []
    for st, mod in ((static, nn), (rstatic, rnn)):
        prog = st.Program()
        with st.program_guard(prog):
            a = _data(st, "a", [], "float32")
            b = _data(st, "b", [], "float32")
            x = _data(st, "x", [2], "float32")
            out = mod.case([(a > 0, lambda: x + 1), (b > 0, lambda: x * 3)],
                           default=lambda: x * 0)
        outs.append(_exe(st).run(prog, feed={
            "a": np.float32(flags[0]), "b": np.float32(flags[1]),
            "x": np.array([1., 2.], np.float32)}, fetch_list=[out])[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_branch_structures_must_match():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2], "float32", device=CPU)
        with pytest.raises(ValueError, match="structure"):
            nn.cond(x.sum() > 0, lambda: (x, x), lambda: x)


# -- training through recorded control flow ------------------------------------

def _cf_loss(pkg, mod, x, k, n, w):
    """cond, switch_case and a bounded differentiable while_loop."""
    kw = {"device": CPU} if pkg is pt else {}
    h = pkg.matmul(x, w)
    h = mod.cond(h.sum() > 0, lambda: pkg.tanh(h), lambda: h * 0.5)
    h = mod.switch_case(k, {0: lambda: h + 1.0, 1: lambda: h * 2.0},
                        default=lambda: h - 1.0)
    i0 = pkg.zeros([], dtype="int32", **kw)
    _, h = mod.while_loop(
        lambda i, a: i < n,
        lambda i, a: [i + 1, pkg.tanh(pkg.matmul(a, w)) + x],
        [i0, h], maximum_trip_count=4)
    return pkg.mean(h * h)


def _cf_feeds(steps):
    rng = np.random.RandomState(3)
    return [{"x": rng.randn(2, 4).astype(np.float32), "k": np.int32(s % 3),
             "n": np.int32(2 + s % 2)} for s in range(steps)]


W0 = (np.random.RandomState(5).randn(4, 4) * 0.3).astype(np.float32)


def test_control_flow_program_trains_like_eager_steps():
    """3 SGD steps of a program with cond, switch_case and a bounded
    differentiable while_loop: bitwise the port's eager steps, and within
    1e-5 relative of the reference's eager steps. (The reference's own
    Program gets this case wrong: its value_and_grad through a recorded
    cond over an intermediate returns a zero loss, ROADMAP reference
    faults.)"""
    feeds = _cf_feeds(3)
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 4], "float32", device=CPU)
        k = static.data("k", [], "int32", device=CPU)
        n = static.data("n", [], "int32", device=CPU)
        w = static.create_parameter([4, 4], "float32", device=CPU)
        w.set_value(W0)
        loss = _cf_loss(pt, nn, x, k, n, w)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    assert {"conditional_block", "switch", "while"} <= set(prog.op_names())
    exe = static.Executor(CPU)
    got = [float(exe.run(prog, feed=f, fetch_list=[loss])[0]) for f in feeds]

    ew = torch.nn.Parameter(torch.from_numpy(W0.copy()))
    eopt = pt.optimizer.SGD(learning_rate=0.1, parameters=[ew])
    rw = rstatic.create_parameter([4, 4], "float32")
    rw.set_value(W0)
    ropt = ref.optimizer.SGD(learning_rate=0.1, parameters=[rw])
    eager, reference = [], []
    for f in feeds:
        el = _cf_loss(pt, nn, torch.from_numpy(f["x"]), t(f["k"]),
                      t(f["n"]), ew)
        el.backward()
        eopt.step()
        eopt.clear_grad()
        eager.append(float(el))
        rl = _cf_loss(ref, rnn, rt(f["x"]), rt(f["k"]), rt(f["n"]), rw)
        rl.backward()
        ropt.step()
        ropt.clear_grad()
        reference.append(float(rl.numpy()))
    assert got == eager
    assert torch.equal(w.detach(), ew.detach())
    np.testing.assert_allclose(got, reference, rtol=REL)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(rw.numpy()),
                               rtol=REL, atol=1e-7)


_PERMUTING_BODIES = {
    "fibonacci": lambda i, a, b: [i + 1, a + b, a],
    "swap": lambda i, a, b: [i + 1, b, a],
    "view_of_another": lambda i, a, b: [i + 1, b * 1.5, a.reshape([2])],
}


@pytest.mark.parametrize("kind", sorted(_PERMUTING_BODIES))
def test_loop_buffers_take_each_result_as_of_the_iteration_start(kind):
    """A captured WHILE iteration writes its results into the loop's
    buffers in place (``control_flow._assign``); a body that hands one
    variable back in another's position must still read every variable as
    the iteration began, as the eager loop and the reference's
    ``lax.while_loop`` do. Driven here with the iteration's own update on
    CPU buffers."""
    from paddle_tpu_torch.nn.control_flow import _assign
    body = _PERMUTING_BODIES[kind]
    start = [t(0), t([1.0, 2.0]), t([3.0, -1.0])]
    carry = [v.clone() for v in start]
    while int(carry[0]) < 6:
        _assign(carry, body(*carry))
    eager = nn.while_loop(lambda i, a, b: i < 6, body,
                          [v.clone() for v in start])
    want = rnn.while_loop(lambda i, a, b: i < 6, body,
                          [rt(v.numpy()) for v in start])
    for c, e, w in zip(carry, eager, want):
        assert torch.equal(c, e)
        np.testing.assert_allclose(c.numpy(), np.asarray(w.numpy()),
                                   rtol=REL)


@pytest.mark.parametrize("n", [4, 6])
def test_bounded_loop_poisons_a_truncated_result(n):
    """Past its bound a recorded loop's float outputs are NaN, as the
    reference's masked loop makes them."""
    outs = []
    for pkg, st, mod in ((pt, static, nn), (ref, rstatic, rnn)):
        prog = st.Program()
        kw = {"device": CPU} if st is static else {}
        with st.program_guard(prog):
            nn_ = _data(st, "n", [], "int32")
            w = st.create_parameter([1], "float32", **kw)
            w.set_value(np.array([1.1], np.float32))
            i = pkg.zeros([], dtype="int32", **kw)
            acc = pkg.ones([1], dtype="float32", **kw)
            _, acc = mod.while_loop(lambda i, a: i < nn_,
                                    lambda i, a: [i + 1, a * w], [i, acc],
                                    maximum_trip_count=4)
        outs.append(_exe(st).run(prog, feed={"n": np.int32(n)},
                                 fetch_list=[acc])[0])
    if n == 4:
        np.testing.assert_allclose(outs[0], outs[1], rtol=REL)
        assert np.isfinite(outs[0]).all()
    else:
        assert np.isnan(outs[0]).all() and np.isnan(outs[1]).all()


def test_gradient_fetch_through_recorded_cond():
    """d(loss)/d(x) through a recorded cond is the taken branch's: the
    untaken branch (sqrt at 0, an infinite derivative) adds nothing."""
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [3], "float32", device=CPU)
        f = static.data("f", [], "float32", device=CPU)
        out = nn.cond(f > 0, lambda: (x * 2.0).sum(),
                      lambda: torch.sqrt(x).sum())
    (g,) = static.gradients(out, [x])
    exe = static.Executor(CPU)
    (gv,) = exe.run(prog, feed={"x": np.zeros(3, np.float32),
                                "f": np.float32(1.0)}, fetch_list=[g])
    np.testing.assert_array_equal(gv, [2.0, 2.0, 2.0])
    (gv,) = exe.run(prog, feed={"x": np.zeros(3, np.float32),
                                "f": np.float32(-1.0)}, fetch_list=[g])
    assert np.isinf(gv).all()  # the sqrt branch taken: its own derivative
