"""The Program passes and pruning on the CPU (``static.passes``), held
against ``paddle_tpu``'s: ``delete_dropout_op_pass``,
``remove_stat_update_pass``, ``prune`` with its buffer-write fixpoint,
the registry, and a rewritten program's training identity and compile
cache.

The reference records a batch norm's running-statistics update as an op
of its own (``batch_norm_stat_update``); the port's ``batch_norm`` op
writes them itself (``mutates``), so the tests hold the effect (the
buffers move or stay) rather than that op's name.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.static as rstatic
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as static
from paddle_tpu_torch.bridge import load_reference_state

CPU = "cpu"
X = np.random.RandomState(0).rand(2, 4, 3, 3).astype(np.float32)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _exe(st):
    return st.Executor(CPU) if st is static else st.Executor()


def _bn_prog(pkg, st, conv, bn):
    prog = st.Program()
    with st.program_guard(prog):
        x = (st.data("x", [2, 4, 3, 3], "float32", device=CPU)
             if st is static else st.data("x", [2, 4, 3, 3], "float32"))
        pre = conv(x)
        post = bn(pre)
        loss = pkg.mean(post)
    return prog, pre, post, loss


def _pair():
    ref.seed(1)
    rconv, rbn = ref.nn.Conv2D(4, 4, 1), ref.nn.BatchNorm2D(4)
    sd = {**{f"c.{k}": v for k, v in rconv.state_dict().items()},
          **{f"b.{k}": v for k, v in rbn.state_dict().items()}}
    sd = {k: np.asarray(v.numpy()) for k, v in sd.items()}
    pconv = load_reference_state(pt.nn.Conv2D(4, 4, 1, device=CPU), {
        k[2:]: v for k, v in sd.items() if k.startswith("c.")})
    pbn = load_reference_state(pt.nn.BatchNorm2D(4, device=CPU), {
        k[2:]: v for k, v in sd.items() if k.startswith("b.")})
    return (pt, static, pconv, pbn), (ref, rstatic, rconv, rbn)


@pytest.mark.parametrize("target", ["post", "pre"])
def test_prune_through_buffer_writes_matches_the_reference(target):
    """Pruned to the batch norm's output, the program keeps the op that
    writes its running statistics, and a run moves them as the
    reference's; pruned to the convolution's, neither keeps it."""
    stats = []
    for pkg, st, conv, bn in _pair():
        prog, pre, post, _loss = _bn_prog(pkg, st, conv, bn)
        t = post if target == "post" else pre
        pruned = st.prune(prog, [t])
        names = pruned.op_names()
        assert ("batch_norm" in names) == (target == "post")
        (out,) = _exe(st).run(pruned, feed={"x": X}, fetch_list=[t])
        stats.append((np.asarray(out), np.asarray(bn._mean.numpy()),
                      np.asarray(bn._variance.numpy())))
    for got, want in zip(stats[0], stats[1]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if target == "pre":
        np.testing.assert_array_equal(stats[0][1], np.zeros(4, np.float32))


def test_delete_dropout_pass():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [4, 8], "float32", device=CPU)
        out = pt.nn.functional.dropout(x, p=0.5, training=True)
    rewritten = static.apply_pass(prog, "delete_dropout_op_pass")
    feed = np.ones((4, 8), np.float32)
    exe = static.Executor(CPU)
    (r,) = exe.run(rewritten, feed={"x": feed}, fetch_list=[out])
    np.testing.assert_array_equal(r, feed)
    (r0,) = exe.run(prog, feed={"x": feed}, fetch_list=[out])
    assert (r0 == 0).any()  # the original still drops


def test_delete_dropout_without_dropout():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 4], "float32", device=CPU)
        y = pt.tanh(x)
    out = static.apply_pass(prog, "delete_dropout_op_pass")
    assert out is not prog and out.op_names() == prog.op_names()
    (got,) = static.Executor(CPU).run(
        out, feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[y])
    np.testing.assert_allclose(got, np.tanh(np.ones((2, 4))), rtol=1e-6)


def test_registry():
    with pytest.raises(KeyError, match="unknown pass"):
        static.apply_pass(static.Program(), "nope_pass")
    assert {"delete_dropout_op_pass", "remove_stat_update_pass",
            "serving_bf16_cast_pass"} <= set(static.list_passes())

    @static.register_pass("test_reverse_nothing")
    def _noop(prog):
        return prog._shallow(list(prog.ops))
    assert "test_reverse_nothing" in static.list_passes()


def test_pass_composition_order_and_stat_removal():
    def build():
        prog = static.Program()
        bn = pt.nn.BatchNorm2D(4, device=CPU)
        with static.program_guard(prog):
            x = static.data("x", [2, 4, 3, 3], "float32", device=CPU)
            h = pt.nn.functional.dropout(bn(x), p=0.5, training=True)
            y = pt.mean(h)
        return prog, bn, y
    runs = []
    for order in (["delete_dropout_op_pass", "remove_stat_update_pass"],
                  ["remove_stat_update_pass", "delete_dropout_op_pass"]):
        prog, bn, y = build()
        out = static.apply_pass(prog, order)
        assert out.op_names() == prog.op_names()
        assert not any(op.mutates for op in out.ops)
        (v,) = static.Executor(CPU).run(out, feed={"x": X}, fetch_list=[y])
        assert torch.equal(bn._mean, torch.zeros(4))  # no stats written
        runs.append(v)
    np.testing.assert_array_equal(runs[0], runs[1])


def test_pass_output_has_its_own_compile_cache():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 4], "float32", device=CPU)
        y = pt.nn.functional.dropout(x, p=0.5, training=True)
    exe = static.Executor(CPU)
    feed = {"x": np.ones((2, 4), np.float32)}
    exe.run(prog, feed=feed, fetch_list=[y])
    n = len(prog._compiled)
    out = static.apply_pass(prog, "delete_dropout_op_pass")
    assert n >= 1 and out._compiled == {}
    (got,) = exe.run(out, feed=feed, fetch_list=[y])
    np.testing.assert_array_equal(got, np.ones((2, 4)))
    assert len(prog._compiled) == n


def _train_prog():
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 4], "float32", device=CPU)
        w = static.create_parameter([4, 1], "float32", device=CPU)
        h = pt.matmul(x, w)
        loss = pt.mean(h)
        pt.optimizer.SGD(learning_rate=0.1, parameters=[w]).minimize(loss)
    return prog, w, h, loss


def test_rewritten_program_still_trains():
    prog, w, _h, loss = _train_prog()
    out = static.apply_pass(prog, "remove_stat_update_pass")
    assert out._optimizer is prog._optimizer
    assert out._loss_slot == prog._loss_slot
    before = w.detach().clone()
    static.Executor(CPU).run(out, feed={"x": np.ones((2, 4), np.float32)},
                             fetch_list=[loss])
    # d mean(x w)/dw = mean over rows of x = 1/1 per element (x all ones)
    torch.testing.assert_close(w.detach(), before - 0.1 * 1.0)


def test_prune_away_from_the_loss_drops_training():
    prog, _w, h, loss = _train_prog()
    assert static.prune(prog, [loss])._optimizer is not None
    pruned = static.prune(prog, [h])
    assert pruned._optimizer is None and pruned._loss_slot is None


def test_prune_slice_matches_the_reference():
    kept = []
    for pkg, st in ((pt, static), (ref, rstatic)):
        prog = st.Program()
        with st.program_guard(prog):
            x = (st.data("x", [2, 4], "float32", device=CPU)
                 if st is static else st.data("x", [2, 4], "float32"))
            a = pkg.tanh(x)
            b = pkg.mean(a)
            c = pkg.exp(x)
            pkg.sum(c)
        pruned = st.prune(prog, [b])
        kept.append(pruned.op_names())
        feed = np.random.RandomState(0).rand(2, 4).astype(np.float32)
        exe = _exe(st)
        (want,) = exe.run(prog, feed={"x": feed}, fetch_list=[b])
        (got,) = exe.run(pruned, feed={"x": feed}, fetch_list=[b])
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert kept[0] == kept[1] == ["tanh", "mean"]
    with pytest.raises(ValueError, match="not.*recorded"):
        static.prune(static.Program(), [pt.ones([2], device=CPU)])
