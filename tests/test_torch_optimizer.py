"""The port's optimizers, LR schedulers and gradient clips against the
reference's: the same parameters and the same gradients (numpy, from a
seed) go through ``paddle_tpu.optimizer`` and ``paddle_tpu_torch.
optimizer`` for 5 steps, and the parameters, moments, masters, step count
and learning rate are compared after every step. The last test carries a
reference AdamW's state across with ``bridge.load_reference_optimizer_state``
halfway and goes on from there.

Tolerances: float32 state rtol 1e-5 / atol 1e-6 (the same float32 update
in another operation order, so values of size O(1) may differ by an ulp,
~2e-7, on their way; both take the bias correction in float32 from the
step count). bf16 parameters are the cast of masters that agree
to 1e-5, so they agree to one bf16 rounding step (rtol 2^-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as RefParameter
from paddle_tpu_torch import nn, optimizer, regularizer
from paddle_tpu_torch.bridge import (load_reference_optimizer_state,
                                     optimizer_state_numpy)
from paddle_tpu_torch.optimizer import lr as port_lr

SHAPES = {"fc.weight": (8, 6), "fc.bias": (6,), "ln.weight": (6,)}
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _values(seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype("float32") for n, s in SHAPES.items()}


def _make(dtype, named=True):
    """(reference params, port params) with the same values; reference
    params carry the structured name when ``named``, else an auto name."""
    vals = _values(0)
    ref = [RefParameter(jnp.asarray(v).astype(dtype),
                        name=n if named else None) for n, v in vals.items()]
    port = []
    for n, v in vals.items():
        p = torch.nn.Parameter(torch.from_numpy(v).to(getattr(torch, dtype)))
        p.param_name = n
        port.append(p)
    return ref, port


def _set_grads(ref, port, step, scale=0.5):
    for i, (r, p) in enumerate(zip(ref, port)):
        g = (np.random.RandomState(100 * step + i).randn(*p.shape)
             * scale).astype("float32")
        r._grad = jnp.asarray(g).astype(r._value.dtype)
        p.grad = torch.from_numpy(g).to(p.dtype)


def _ref_state(opt, names=None):
    out = {}
    for k, v in opt.state_dict().items():
        if k == "LR_Scheduler":
            continue
        if names and not k.startswith("@"):
            pname, slot = k.rsplit(".", 1)
            k = f"{names[pname]}.{slot}"
        out[k] = np.asarray(v.numpy(), dtype=np.float32)
    return out


def _compare(ref, port, ref_opt, port_opt, names=None):
    for r, p in zip(ref, port):
        tol = BF16 if p.dtype == torch.bfloat16 else F32
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(r._value, np.float32), **tol,
                                   err_msg=p.param_name)
    want = _ref_state(ref_opt, names)
    got = {k: v for k, v in optimizer_state_numpy(port_opt).items()
           if k != "LR_Scheduler"}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), want[k],
                                   **F32, err_msg=k)


def _train(make_opts, dtype="float32", steps=5, scale=0.5):
    ref, port = _make(dtype)
    ref_opt, port_opt, scheds = make_opts(ref, port)
    for step in range(steps):
        _set_grads(ref, port, step, scale)
        ref_opt.step()
        port_opt.step()
        ref_opt.clear_grad()
        port_opt.clear_grad()
        assert all(p.grad is None for p in port)
        for s in scheds:
            s.step()
        _compare(ref, port, ref_opt, port_opt)
    return ref_opt, port_opt


def _no_bias(name):
    return not name.endswith("bias")


@pytest.mark.parametrize("case", ["plain", "l2decay", "clip_value",
                                  "clip_norm"])
def test_adam_matches_reference(case):
    kw_ref, kw_port = {}, {}
    if case == "l2decay":
        kw_ref["weight_decay"] = paddle.regularizer.L2Decay(0.05)
        kw_port["weight_decay"] = regularizer.L2Decay(0.05)
    elif case == "clip_value":
        kw_ref["grad_clip"] = paddle.nn.ClipGradByValue(0.3)
        kw_port["grad_clip"] = nn.ClipGradByValue(0.3)
    elif case == "clip_norm":
        kw_ref["grad_clip"] = paddle.nn.ClipGradByNorm(0.5)
        kw_port["grad_clip"] = nn.ClipGradByNorm(0.5)

    def make(ref, port):
        return (paddle.optimizer.Adam(learning_rate=1e-2, parameters=ref,
                                      **kw_ref),
                optimizer.Adam(learning_rate=1e-2, parameters=port,
                               **kw_port), [])
    _train(make)


def test_adamw_decay_fun_matches_reference():
    def make(ref, port):
        return (paddle.optimizer.AdamW(learning_rate=1e-2, parameters=ref,
                                       weight_decay=0.1,
                                       apply_decay_param_fun=_no_bias),
                optimizer.AdamW(learning_rate=1e-2, parameters=port,
                                weight_decay=0.1,
                                apply_decay_param_fun=_no_bias), [])
    _train(make)


def test_adamw_bf16_masters_clip_and_warmup_match_reference():
    """The training recipe: bf16 parameters with float32 masters, a
    global-norm clip that bites (gradient norm ~4 against 1.0) and a
    linear warm-up."""
    def make(ref, port):
        rs = paddle.optimizer.lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2)
        ps = port_lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2)
        return (paddle.optimizer.AdamW(
                    learning_rate=rs, parameters=ref, multi_precision=True,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
                    apply_decay_param_fun=_no_bias),
                optimizer.AdamW(
                    learning_rate=ps, parameters=port, multi_precision=True,
                    grad_clip=nn.ClipGradByGlobalNorm(1.0),
                    apply_decay_param_fun=_no_bias), [rs, ps])
    ref_opt, port_opt = _train(make, dtype="bfloat16")
    state = optimizer_state_numpy(port_opt)
    assert {k.rsplit(".", 1)[1] for k in state if "." in k} == {
        "moment1", "moment2", "master"}
    assert all(state[f"{n}.master"].dtype == np.float32 for n in SHAPES)


def test_cosine_annealing_with_global_norm_clip_matches_reference():
    def make(ref, port):
        rs = paddle.optimizer.lr.CosineAnnealingDecay(1e-2, T_max=4,
                                                      eta_min=1e-4)
        ps = port_lr.CosineAnnealingDecay(1e-2, T_max=4, eta_min=1e-4)
        return (paddle.optimizer.AdamW(
                    learning_rate=rs, parameters=ref,
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(2.0)),
                optimizer.AdamW(
                    learning_rate=ps, parameters=port,
                    grad_clip=nn.ClipGradByGlobalNorm(2.0)), [rs, ps])
    _train(make, scale=2.0)


@pytest.mark.parametrize("steps", [0, 3, 7])
def test_schedulers_match_reference(steps):
    pairs = [(paddle.optimizer.lr.LinearWarmup(0.1, 4, 0.0, 0.1),
              port_lr.LinearWarmup(0.1, 4, 0.0, 0.1)),
             (paddle.optimizer.lr.LinearWarmup(
                  paddle.optimizer.lr.CosineAnnealingDecay(0.1, 5), 2, 0.01,
                  0.1),
              port_lr.LinearWarmup(port_lr.CosineAnnealingDecay(0.1, 5), 2,
                                   0.01, 0.1)),
             (paddle.optimizer.lr.CosineAnnealingDecay(0.1, 5, 0.001),
              port_lr.CosineAnnealingDecay(0.1, 5, 0.001))]
    for ref, port in pairs:
        for _ in range(steps):
            ref.step()
            port.step()
        assert port.last_lr == pytest.approx(ref.last_lr, rel=1e-12)
        assert port.state_dict() == pytest.approx(ref.state_dict())


def test_carried_reference_state_continues_in_the_port():
    """Two reference AdamW steps on bf16 params, then its moments, masters,
    step and lr carried into a fresh port AdamW (reference auto names
    mapped to structured names) and three more steps on both."""
    ref, port = _make("bfloat16", named=False)
    names = {r.name: p.param_name for r, p in zip(ref, port)}
    kw = dict(learning_rate=1e-2, multi_precision=True, weight_decay=0.05)
    ref_opt = paddle.optimizer.AdamW(parameters=ref, **kw)
    for step in range(2):
        _set_grads(ref, port, step)
        ref_opt.step()
        ref_opt.clear_grad()
    with torch.no_grad():
        for r, p in zip(ref, port):
            p.copy_(torch.from_numpy(np.asarray(r._value, np.float32)))
    port_opt = optimizer.AdamW(parameters=port, **kw)
    ref_state = {k: np.asarray(v.numpy()) for k, v in
                 ref_opt.state_dict().items()}
    load_reference_optimizer_state(port_opt, ref_state, names)
    assert port_opt._step_count == 2
    _compare(ref, port, ref_opt, port_opt, names)
    for step in range(2, 5):
        _set_grads(ref, port, step)
        ref_opt.step()
        port_opt.step()
        ref_opt.clear_grad()
        port_opt.clear_grad()
        _compare(ref, port, ref_opt, port_opt, names)


def test_bridge_refuses_mismatched_state():
    _, port = _make("float32")
    opt = optimizer.AdamW(parameters=port)
    state = {k: v for k, v in optimizer_state_numpy(opt).items()}
    names = {n: n for n in SHAPES}
    with pytest.raises(ValueError, match="missing"):
        load_reference_optimizer_state(
            opt, {k: v for k, v in state.items() if "bias" not in k}, names)
    bad = dict(state, **{"fc.bias.moment1": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_reference_optimizer_state(opt, bad, names)
    with pytest.raises(ValueError, match="no structured name"):
        load_reference_optimizer_state(opt, state, {})


def test_unported_options_raise():
    _, port = _make("float32")
    # fuse_accumulators is ported; what refuses it is the reference's
    # refusal: gradient merge's per-parameter rollback
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        GradientMergeOptimizer)
    fused = optimizer.Adam(parameters=port, fuse_accumulators=True)
    with pytest.raises(NotImplementedError, match="fuse_accumulators"):
        GradientMergeOptimizer(fused, k_steps=2)
    opt = optimizer.AdamW(parameters=port)
    with pytest.raises(RuntimeError, match="ZeRO needs an active mesh"):
        opt._zero_enable(axis="dp", stage=1)  # ported: it needs a mesh
    port[0].grad = torch.zeros(8, 6).to_sparse()
    with pytest.raises(NotImplementedError, match="sparse"):
        opt.step()


def test_step_and_lr_are_tensors_on_the_parameters_device():
    """``@step`` (int32) and ``@lr`` (float32) live as scalar tensors
    beside the parameters; a step reads neither on the host."""
    _, port = _make("float32")
    sched = port_lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2)
    opt = optimizer.AdamW(parameters=port, learning_rate=sched)
    for t, dtype in ((opt._step_count, torch.int32),
                     (opt._lr.tensor, torch.float32)):
        assert t.dim() == 0 and t.dtype == dtype
        assert t.device == port[0].device
    _set_grads(_make("float32")[0], port, 0)
    opt.step()
    sched.step()
    state = opt.state_dict()
    assert int(state["@step"]) == 1
    assert float(state["@lr"]) == pytest.approx(sched.last_lr, rel=1e-7)
    assert opt.get_lr() == float(np.float32(sched.last_lr))


def test_scheduler_step_between_program_calls_takes_effect():
    """A scheduler stepped between two calls of a k-step program writes
    the new rate into the lr tensor, which the next call's updates read:
    the program matches eager steps on the same schedule, and differs from
    a run whose scheduler was not stepped."""
    from paddle_tpu_torch import jit
    xs = torch.from_numpy(np.random.RandomState(4).randn(2, 5, 8)
                          .astype("float32"))

    def run(program, step_sched):
        _, port = _make("float32")
        sched = port_lr.LinearWarmup(1e-1, 4, 1e-3, 1e-1)
        opt = optimizer.AdamW(parameters=port, learning_rate=sched)

        def body(x):
            loss = (x @ port[0] + port[1]).square().mean() + port[2].sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        step = jit.to_static(body, scan_steps=2) if program else body
        for _ in range(2):
            if program:
                step(xs)
            else:
                for i in range(2):
                    step(xs[i])
            if step_sched:
                sched.step()
        return [p.detach().clone() for p in port]

    stepped = run(True, True)
    for a, b in zip(stepped, run(False, True)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b)
                   for a, b in zip(stepped, run(True, False)))


def test_rate_set_inside_a_capture_raises(monkeypatch):
    """Under CUDA-graph capture a scheduler step would freeze one rate into
    every replay: it raises instead."""
    from paddle_tpu_torch.optimizer import optimizer as opt_mod
    _, port = _make("float32")
    sched = port_lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2)
    optimizer.AdamW(parameters=port, learning_rate=sched)
    monkeypatch.setattr(opt_mod, "_capturing", lambda t: True)
    with pytest.raises(RuntimeError, match="captured program"):
        sched.step()


def test_global_norm_clip_never_reads_the_host(monkeypatch):
    """``ClipGradByGlobalNorm`` (and the step around it) stays on the
    device: no ``.item()``, ``float()``, ``int()``, ``bool()``,
    ``.tolist()`` or ``.numpy()`` of a tensor."""
    _, port = _make("bfloat16")
    opt = optimizer.AdamW(parameters=port, multi_precision=True,
                          grad_clip=nn.ClipGradByGlobalNorm(0.1))
    _set_grads(_make("float32")[0], port, 0)
    calls = []
    for name in ("item", "__float__", "__int__", "__bool__", "tolist",
                 "numpy"):
        def spy(self, *a, _name=name, **kw):
            calls.append(_name)
            raise AssertionError(f"host read: Tensor.{_name}")
        monkeypatch.setattr(torch.Tensor, name, spy)
    clipped = nn.ClipGradByGlobalNorm(0.1)([(p, p.grad) for p in port])
    opt.step()
    monkeypatch.undo()
    assert calls == []
    norm = torch.sqrt(sum(g.float().square().sum() for _, g in clipped))
    assert float(norm) == pytest.approx(0.1, rel=1e-2)
