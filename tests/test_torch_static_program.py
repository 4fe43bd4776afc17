"""The static graph on the CPU: ``static.Program``, ``Executor``,
``append_backward``/``gradients`` (the ``@GRAD`` fetches), ``minimize``
under a program, ``save``/``load``, ``Block``/``Operator``, ``py_func``
and the recording branches of ``amp_guard``, BatchNorm and SpectralNorm,
each held against ``paddle_tpu``'s static graph on the same numpy inputs
(float32: 1e-5 relative).

The two packages record at different seams (the reference's ``call_op``,
the port's torch calls and its own functionals), so op names differ where
torch names an op otherwise (ROADMAP, deliberate differences); the tests
compare names only where both name it alike, and otherwise values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.static as rstatic
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as static
from paddle_tpu_torch.bridge import load_reference_state

REL = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, (got, want)


def _linear_pair(w_val):
    """The same small program in both packages: out = x @ w, loss =
    mean(out * out)."""
    progs = []
    for pkg, st, dev in ((pt, static, {"device": CPU}), (ref, rstatic, {})):
        prog = st.Program()
        with st.program_guard(prog):
            x = st.data("x", [None, 4], "float32", **dev)
            w = st.create_parameter([4, 3], "float32", **dev)
            w.set_value(w_val)
            out = pkg.matmul(x, w)
            loss = pkg.mean(out * out)
        progs.append((prog, x, w, out, loss))
    return progs


W = np.random.RandomState(11).randn(4, 3).astype(np.float32)
FEED = np.random.RandomState(0).rand(2, 4).astype(np.float32)


def _run_both(build, fetch):
    """``build(prog, x, w, out, loss, st) -> handles``; fetches on both."""
    outs = []
    for (prog, x, w, out, loss), st, exe in zip(
            _linear_pair(W), (static, rstatic),
            (static.Executor(CPU), rstatic.Executor())):
        handles = build(prog, x, w, out, loss, st)
        outs.append(exe.run(prog, feed={"x": FEED}, fetch_list=fetch(
            x, w, out, loss, handles)))
    return outs


@pytest.mark.parametrize("case", ["param_and_feed", "intermediate",
                                  "seeded", "multi_target", "no_grad_set"])
def test_gradients_match_the_reference(case):
    seed = np.random.RandomState(2).rand(2, 3).astype(np.float32)

    def build(prog, x, w, out, loss, st):
        if case == "param_and_feed":
            return st.gradients(loss, [w, x])
        if case == "intermediate":
            return st.gradients(loss, [out])
        if case == "seeded":
            return st.gradients([out], [w], target_gradients=[seed])
        if case == "multi_target":
            with st.program_guard(prog):
                t1 = (pt if st is static else ref).mean(out)
            return st.gradients([t1, loss], [w])
        h = out  # no_grad_set: out is a constant of the backward
        return st.gradients(loss, [w], no_grad_set=[h])

    got, want = _run_both(build, lambda x, w, out, loss, h: [loss, *h])
    assert len(got) == len(want)
    for g, r in zip(got, want):
        _close(g, r)
    if case == "no_grad_set":
        assert np.abs(np.asarray(got[1])).max() == 0.0


def test_append_backward_pairs_and_names():
    (prog, x, w, out, loss), _ = _linear_pair(W)
    with static.program_guard(prog):
        pairs = static.append_backward(loss)
    assert len(pairs) == 1
    p, g = pairs[0]
    assert p is w and g.name == w.param_name + "@GRAD"
    (gv,) = static.Executor(CPU).run(prog, feed={"x": FEED}, fetch_list=[g])
    xw = FEED @ W
    _close(gv, 2 * FEED.T @ xw / xw.size)


def test_refusals():
    from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                               UnimplementedError)
    (prog, x, w, out, loss), _ = _linear_pair(W)
    exe = static.Executor(CPU)
    g1 = static.gradients(loss, [w])[0]
    g2 = static.gradients(out, [w])[0]
    with pytest.raises(InvalidArgumentError, match="same target"):
        exe.run(prog, feed={"x": FEED}, fetch_list=[g1, g2])
    stray = pt.ones([4], device=CPU)
    with pytest.raises(InvalidArgumentError, match="never used"):
        exe.run(prog, feed={"x": FEED},
                fetch_list=static.gradients(loss, [stray]))
    with pytest.raises(InvalidArgumentError, match="no_grad_set"):
        exe.run(prog, feed={"x": FEED},
                fetch_list=static.gradients(loss, [w], no_grad_set=[w]))
    with static.program_guard(prog):
        pairs = static.append_backward(loss)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    with pytest.raises(UnimplementedError, match="train step"):
        exe.run(prog, feed={"x": FEED}, fetch_list=[loss, pairs[0][1]])


def test_block_and_operator_introspection():
    (prog, x, w, out, loss), _ = _linear_pair(W)
    block = prog.global_block()
    assert block.idx == 0 and prog.num_blocks() == 1
    types = [op.type for op in block.ops]
    assert types == prog.op_names() and "matmul" in types
    mm = block.ops[types.index("matmul")]
    assert len(mm.input_arg_names()) == 2 and len(mm.output_arg_names()) == 1
    assert block.var(w.param_name) is w and block.var("x") is x
    assert w in block.all_parameters()
    with pytest.raises(ValueError):
        block.var("nope")


def test_build_takes_back_its_random_draws_and_buffer_writes():
    pt.seed(3)
    bn = pt.nn.BatchNorm1D(4, device=CPU)
    before = (bn._mean.clone(), bn._variance.clone())
    state = pt.get_rng_state(CPU).clone()
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [8, 4], "float32", device=CPU)
        y = pt.nn.functional.dropout(bn(x * 3.0 + 1.0), p=0.5)
    assert torch.equal(pt.get_rng_state(CPU), state)
    assert torch.equal(bn._mean, before[0])
    assert torch.equal(bn._variance, before[1])
    bn_op = prog.ops[prog.op_names().index("batch_norm")]
    assert bn_op.mutates  # the running statistics, written at each run
    exe = static.Executor(CPU)
    feed = np.random.RandomState(4).rand(8, 4).astype(np.float32)
    exe.run(prog, feed={"x": feed}, fetch_list=[y])
    xs = feed * 3.0 + 1.0
    _close(bn._mean.numpy(), 0.9 * before[0].numpy() + 0.1 * xs.mean(0))
    _close(bn._variance.numpy(), 0.9 * before[1].numpy() + 0.1 * xs.var(0))


def test_batchnorm_program_matches_the_reference():
    """Train-mode BatchNorm inside a program: output and the running
    statistics the reference's Executor writes back, after two runs."""
    ref_bn = ref.nn.BatchNorm1D(4)
    port_bn = load_reference_state(pt.nn.BatchNorm1D(4, device=CPU), {
        k: np.asarray(v.numpy()) for k, v in ref_bn.state_dict().items()})
    outs = []
    for pkg, st, bn, dev in ((pt, static, port_bn, {"device": CPU}),
                             (ref, rstatic, ref_bn, {})):
        prog = st.Program()
        with st.program_guard(prog):
            x = st.data("x", [8, 4], "float32", **dev)
            y = bn(x)
        exe = st.Executor(CPU) if st is static else st.Executor()
        for seed in (5, 6):
            feed = np.random.RandomState(seed).rand(8, 4).astype(np.float32)
            (yv,) = exe.run(prog, feed={"x": feed}, fetch_list=[y])
        outs.append((yv, bn.state_dict()))
    _close(outs[0][0], outs[1][0])
    for k, v in outs[1][1].items():
        _close(_np(outs[0][1][k]), np.asarray(v.numpy()))


def test_spectral_norm_power_step_is_recorded():
    """The power step is ops of the program, from the vectors' live
    values; as in the reference's recorder, no run writes them back."""
    sn = pt.nn.SpectralNorm([3, 4], power_iters=2, device=CPU)
    u0, v0 = sn.weight_u.detach().clone(), sn.weight_v.detach().clone()
    weight = torch.nn.Parameter(torch.from_numpy(W.T.copy()))
    prog = static.Program()
    with static.program_guard(prog):
        out = sn(weight)
    assert torch.equal(sn.weight_u, u0) and torch.equal(sn.weight_v, v0)
    (got,) = static.Executor(CPU).run(prog, feed={}, fetch_list=[out])
    assert torch.equal(sn.weight_u, u0)
    with torch.no_grad():
        want = sn(weight)  # eager: from the same vectors
    np.testing.assert_array_equal(got, want.numpy())


def test_amp_guard_casts_at_every_replay():
    lin = pt.nn.Linear(4, 3, device=CPU)
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [2, 4], "float32", device=CPU)
        with pt.amp.amp_guard(dtype="bfloat16"):
            y = lin(x)
    (yv,) = static.Executor(CPU).run(prog, feed={"x": FEED},
                                     fetch_list=[y], return_numpy=False)
    assert yv.dtype == torch.bfloat16
    with pt.amp.auto_cast(dtype="bfloat16"):
        want = lin(torch.from_numpy(FEED))
    assert torch.equal(yv.as_subclass(torch.Tensor), want)


def test_py_func_forward_and_backward():
    x = pt.to_tensor(FEED, place=CPU, stop_gradient=False)

    def double(a):
        return a * 2

    def double_grad(a, out, gout):
        return gout * 2
    out = static.py_func(double, x, static.InputSpec([2, 4], "float32"),
                         backward_func=double_grad)
    out.sum().backward()
    np.testing.assert_array_equal(out.numpy(), FEED * 2)
    np.testing.assert_array_equal(x.grad.numpy(), np.full_like(FEED, 2))
    prog = static.Program()
    with static.program_guard(prog):
        xd = static.data("x", [2, 4], "float32", device=CPU)
        y = static.py_func(double, xd, static.InputSpec([2, 4], "float32"))
    assert prog.op_names() == ["py_func"]
    (yv,) = static.Executor(CPU).run(prog, feed={"x": FEED + 1},
                                     fetch_list=[y])
    np.testing.assert_array_equal(yv, (FEED + 1) * 2)


def test_dynamic_mode_flag():
    assert pt.in_dynamic_mode()
    pt.enable_static()
    try:
        assert not pt.in_dynamic_mode()
    finally:
        pt.disable_static()
    assert pt.in_dynamic_mode()


def test_save_and_load_resume_training(tmp_path):
    def build():
        torch.manual_seed(0)
        lin = pt.nn.Linear(4, 3, device=CPU)
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [None, 4], "float32", device=CPU)
            loss = pt.mean(lin(x) ** 2)
            pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return prog, loss, lin
    feeds = [np.random.RandomState(s).rand(2, 4).astype(np.float32)
             for s in range(4)]
    prog, loss, lin = build()
    exe = static.Executor(CPU)
    for f in feeds[:2]:
        exe.run(prog, feed={"x": f}, fetch_list=[loss])
    static.save(prog, str(tmp_path / "ckpt"))
    want = [exe.run(prog, feed={"x": f}, fetch_list=[loss])[0]
            for f in feeds[2:]]
    prog2, loss2, lin2 = build()
    static.load(prog2, str(tmp_path / "ckpt"))
    got = [exe.run(prog2, feed={"x": f}, fetch_list=[loss2])[0]
           for f in feeds[2:]]
    np.testing.assert_array_equal(got, want)
    for a, b in zip(lin.parameters(), lin2.parameters()):
        assert torch.equal(a, b)


def test_executor_compile_cache_and_return_numpy():
    (prog, x, w, out, loss), _ = _linear_pair(W)
    exe = static.Executor(CPU)
    a = exe.run(prog, feed={"x": FEED}, fetch_list=[out])
    b = exe.run(prog, feed={"x": FEED[:1]}, fetch_list=[out])
    c = exe.run(prog, feed={"x": FEED}, fetch_list=[out],
                return_numpy=False)
    assert len(prog._compiled) == 2  # one program per feed shape
    assert isinstance(a[0], np.ndarray) and isinstance(c[0], pt.Tensor)
    np.testing.assert_array_equal(b[0], a[0][:1])
    np.testing.assert_array_equal(c[0].numpy(), a[0])


# -- a 2-layer GPT recorded and trained through minimize + Executor.run --------

GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=16, hidden_dropout=0.0, attention_dropout=0.0)


def test_gpt_program_trains_like_the_reference():
    """3 AdamW steps of a 2-layer GPT (hidden 32, seq 16) recorded into a
    Program in both packages: losses and every parameter after the steps
    within 1e-5 relative (float32; Adam's first steps move an element by
    about the rate, so the parameters are held to 1e-5 of the rate's
    scale, as elsewhere)."""
    from paddle_tpu.models.gpt import GPTConfig as RefCfg
    from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    ref.seed(7)
    rmodel = RefGPT(RefCfg(**GPT))
    state = {k: np.asarray(v.numpy()) for k, v in
             rmodel.state_dict().items()}
    pmodel = load_reference_state(GPTForCausalLM(GPTConfig(**GPT),
                                                 device=CPU), state)
    rng = np.random.RandomState(1)
    batches = [(rng.randint(0, 64, (2, 16)), rng.randint(0, 64, (2, 16)))
               for _ in range(3)]
    losses = []
    for pkg, st, model, dev in ((pt, static, pmodel, {"device": CPU}),
                                (ref, rstatic, rmodel, {})):
        prog = st.Program()
        with st.program_guard(prog):
            ids = st.data("ids", [2, 16], "int64", **dev)
            labels = st.data("labels", [2, 16], "int64", **dev)
            loss = model.loss(model(ids), labels)
            pkg.optimizer.AdamW(learning_rate=1e-3).minimize(loss)
        exe = st.Executor(CPU) if st is static else st.Executor()
        losses.append([float(exe.run(prog, feed={"ids": a, "labels": b},
                                     fetch_list=[loss])[0])
                       for a, b in batches])
    assert {"embedding", "layer_norm", "scaled_dot_product_attention",
            "cross_entropy"} <= set(prog.op_names()) & set(
                static.Program.op_names(_port_prog_of(pmodel, pt)))
    _close(losses[0], losses[1])
    rstate = rmodel.state_dict()
    for name, p in pmodel.state_dict().items():
        if name.endswith("qkv.bias"):
            continue  # its key third steps on rounding noise (zero grad)
        diff = np.abs(_np(p) - np.asarray(rstate[name].numpy())).max()
        assert diff <= 3 * 1e-3 * 1e-3 + REL * np.abs(_np(p)).max(), name


def _port_prog_of(model, pkg):
    prog = static.Program()
    with static.program_guard(prog):
        ids = static.data("ids", [2, 16], "int64", device=CPU)
        model.loss(model(ids), ids)
    return prog


def test_flash_attention_is_one_op_with_the_kernels_backward():
    """Called directly under ``program_guard`` the flash attention is one
    recorded op; its replay's gradient comes through ``FlashAttention``'s
    backward (the plain dQ/dK-dV versions on the CPU)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    qkv = [torch.randn(1, 32, 2, 32, generator=g) for _ in range(3)]
    prog = static.Program()
    with static.program_guard(prog):
        q = static.data("q", [1, 32, 2, 32], "float32", device=CPU)
        out = fa.flash_attention_bshd(q, qkv[1], qkv[2], causal=True)
        loss = pt.mean(out * out)
    assert prog.op_names() == ["flash_attention", "mul", "mean"]
    (gq,) = static.gradients(loss, [q])
    lv, gv = static.Executor(CPU).run(prog, feed={"q": qkv[0].numpy()},
                                      fetch_list=[loss, gq])
    qe = qkv[0].clone().requires_grad_()
    oe = fa.flash_attention_bshd(qe, qkv[1], qkv[2], causal=True)
    assert type(oe.grad_fn).__name__ == "FlashAttentionBackward"
    le = (oe * oe).mean()
    le.backward()
    assert float(lv) == float(le)
    np.testing.assert_array_equal(gv, qe.grad.numpy())


def test_train_and_infer_from_dataset():
    class Batches:
        def __init__(self, feeds):
            self.feeds = feeds

        def batches(self):
            return iter(self.feeds)
    feeds = [{"x": np.random.RandomState(s).rand(2, 4).astype(np.float32)}
             for s in range(3)]
    (prog, x, w, out, loss), _ = _linear_pair(W)
    with static.program_guard(prog):
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = static.Executor(CPU)
    last = exe.train_from_dataset(prog, Batches(feeds), fetch_list=[loss])
    w_trained = w.detach().clone()
    assert not torch.equal(w_trained, torch.from_numpy(W))
    (got,) = exe.infer_from_dataset(prog, Batches(feeds[-1:]),
                                    fetch_list=[loss])
    assert torch.equal(w.detach(), w_trained)  # inference steps nothing
    xw = feeds[-1]["x"] @ w_trained.numpy()
    _close(got, (xw * xw).mean())
    assert last is not None
    with pytest.raises(ValueError, match="dataset"):
        exe.train_from_dataset(prog, None)


def test_minimize_under_a_program_refuses_fused_accumulators():
    (prog, x, w, out, loss), _ = _linear_pair(W)
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=[w],
                            fuse_accumulators=True)
    with static.program_guard(prog):
        with pytest.raises(NotImplementedError, match="fuse_accumulators"):
            opt.minimize(loss)
    with pytest.raises(ValueError, match="parameters are required"):
        pt.optimizer.SGD(learning_rate=0.1)
