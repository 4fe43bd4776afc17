"""``fuse_accumulators``: the optimizer's slots in coalesced ``[rows, 1024]``
float32 stores (``optimizer.zero.FusedState``), every accumulator a view.

- Fused is bitwise unfused, eagerly and under ``jit.to_static``, for
  ``Adam``, ``AdamW`` with bf16 parameters and float32 masters,
  ``Momentum`` and ``Adagrad`` (the reference's Momentum and Adagrad take
  no ``fuse_accumulators`` keyword; ``Optimizer._fuse()`` lays them out),
  and with a parameter that has no gradient at some steps.
- The reference's ``test_fuse_accumulators_parity_and_state_dict`` in the
  port: the ``state_dict``'s per-parameter keys and its round trip through
  ``set_state_dict``.
- A fused checkpoint record (``checkpoint.state``) written by each package
  restores into the other's fused optimizer with equal bytes, and the next
  steps agree: float32 parameters rtol 1e-5 / atol 1e-6 (the same update
  in two libraries); with bf16 parameters the float32 masters within
  2^-8 of their largest magnitude (the two libraries' bf16 forward and
  backward round apart). A fused record into an unfused optimizer, or the
  reverse, raises ``StateMismatchError`` in both packages.
- The refusals: ``GradientMergeOptimizer`` and ``shard_optimizer_state``
  over a fused optimizer, as the reference's.
- The state ledger counts the stores once: the moments' bytes equal the
  reference's fused stores'.
"""
import numpy as np
import pytest
import torch

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _mlp(seed=3, dtype=torch.float32):
    from paddle_tpu_torch import nn
    import paddle_tpu_torch as pt
    pt.seed(seed)
    m = nn.Sequential(nn.Linear(8, 33, device="cpu"), nn.Tanh(),
                      nn.Linear(33, 5, device="cpu"))
    return m.to(dtype)


def _opt(kind, params, fused):
    from paddle_tpu_torch import optimizer
    if kind == "adam":
        return optimizer.Adam(learning_rate=1e-2, parameters=params,
                              fuse_accumulators=fused)
    if kind == "adamw_bf16":
        return optimizer.AdamW(
            learning_rate=1e-2, parameters=params, multi_precision=True,
            apply_decay_param_fun=lambda n: not n.endswith("bias"),
            fuse_accumulators=fused)
    opt = (optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                              parameters=params, use_nesterov=True)
           if kind == "momentum" else
           optimizer.Adagrad(learning_rate=0.1, parameters=params,
                             initial_accumulator_value=0.2))
    if fused:
        opt._fuse()
    return opt


def _run(kind, fused, program, steps=6):
    from paddle_tpu_torch import jit
    dtype = torch.bfloat16 if kind == "adamw_bf16" else torch.float32
    m = _mlp(dtype=dtype)
    opt = _opt(kind, m.parameters(), fused)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 8)
                         .astype("float32")).to(dtype)

    def step(x, freeze):
        loss = m(x).float().square().mean()
        loss.backward()
        if freeze:  # the first layer's bias has no gradient this step
            m[0].bias.grad = None
        opt.step()
        opt.clear_grad()
        return loss.detach()

    fn = jit.to_static(step) if program else step
    losses = [fn(x, i % 3 == 1) for i in range(steps)]
    return torch.stack(losses), m, opt


@pytest.mark.parametrize("program", [False, True], ids=["eager",
                                                        "to_static"])
@pytest.mark.parametrize("kind", ["adam", "adamw_bf16", "momentum",
                                  "adagrad"])
def test_fused_is_bitwise_unfused(kind, program):
    l0, m0, o0 = _run(kind, False, program)
    l1, m1, o1 = _run(kind, True, program)
    assert o1._fused is not None and o0._fused is None
    assert torch.equal(l0, l1)
    for (n, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a, b), n
    s0, s1 = o0.state_dict(), o1.state_dict()
    assert sorted(s0) == sorted(s1)
    for k in s0:
        if k != "LR_Scheduler":
            assert torch.equal(s0[k], s1[k]), k


def test_stores_views_and_state_dict_round_trip():
    """The reference's case: AdamW over Linear(8, 33), Tanh, Linear(33, 5)
    for 6 steps; 4 ``moment1`` keys; values written by ``set_state_dict``
    stick (they go through the views into the stores)."""
    _, m, opt = _run("adam", True, True)
    fused = opt._fused
    assert sorted(fused.stores) == ["moment1", "moment2"]
    rows = sum(-(-p.numel() // 1024) for p in m.parameters())
    assert all(tuple(t.shape) == (rows, 1024) for t in fused.stores.values())
    sd = opt.state_dict()
    keys = [k for k in sd if k.endswith(".moment1")]
    assert len(keys) == 4
    for k in keys:  # each key a view of the moment1 store
        assert sd[k].untyped_storage().data_ptr() == \
            fused.stores["moment1"].untyped_storage().data_ptr()
    _, _, opt2 = _run("adam", True, True)
    new = {k: torch.full_like(sd[k], 0.25) for k in keys}
    opt2.set_state_dict(new)
    for k in keys:
        assert bool((opt2.state_dict()[k] == 0.25).all())
    assert float(opt2._fused.stores["moment1"].sum()) == pytest.approx(
        0.25 * sum(p.numel() for p in m.parameters()))


def test_adagrad_store_starts_at_its_value_over_whole_rows():
    """Each parameter's rows are filled with the start value, its padding
    lanes too, as the reference's ``_FlatStore`` fills them."""
    m = _mlp()
    opt = _opt("adagrad", m.parameters(), True)
    store = opt._fused.stores["moment"]
    assert bool((store == np.float32(0.2)).all())


def _ref_mlp(dtype="float32"):
    import paddle_tpu as paddle
    paddle.seed(3)
    m = paddle.nn.Sequential(paddle.nn.Linear(8, 33), paddle.nn.Tanh(),
                             paddle.nn.Linear(33, 5))
    if dtype != "float32":
        m.to(dtype=dtype)
    return m


def _pair(bf16):
    """A reference and a port AdamW, both fused, over the same weights."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.bridge import load_reference_state
    ref = _ref_mlp("bfloat16" if bf16 else "float32")
    port = _mlp(seed=9, dtype=torch.bfloat16 if bf16 else torch.float32)
    load_reference_state(port, {k: np.asarray(v._value.astype("float32"))
                                for k, v in ref.state_dict().items()})
    kw = dict(learning_rate=1e-2, multi_precision=bf16,
              fuse_accumulators=True)
    return (ref, paddle.optimizer.AdamW(parameters=ref.parameters(), **kw),
            port, optimizer.AdamW(parameters=port.parameters(), **kw))


def _ref_steps(ref, opt, xs):
    import paddle_tpu as paddle
    for x in xs:
        loss = ref(paddle.to_tensor(x)).astype("float32").square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


def _port_steps(port, opt, xs):
    for x in xs:
        loss = port(torch.from_numpy(x).to(port[0].weight.dtype)).float() \
            .square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()


def _xs(first, n):
    return [np.random.RandomState(50 + i).rand(4, 8).astype("float32")
            for i in range(first, first + n)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fused_checkpoint_crosses_between_the_packages(writer, bf16):
    from paddle_tpu.checkpoint import state as ref_state
    from paddle_tpu_torch.checkpoint import state as port_state
    ref, ref_opt, port, port_opt = _pair(bf16)
    if writer == "reference":
        _ref_steps(ref, ref_opt, _xs(0, 2))
        data = ref_state.capture_optimizer(ref_opt)
        assert sorted(data["flat_stores"]) == ["moment1", "moment2"]
        port_state.restore_optimizer(port_opt, data)
        with torch.no_grad():
            for (n, p) in port.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(
                    ref.state_dict()[n]._value.astype("float32"))))
        back = port_state.capture_optimizer(port_opt)
    else:
        _port_steps(port, port_opt, _xs(0, 2))
        data = port_state.capture_optimizer(port_opt)
        assert sorted(data["flat_stores"]) == ["moment1", "moment2"]
        ref_state.restore_optimizer(ref_opt, data)
        for n, p in port.named_parameters():
            ref.state_dict()[n].set_value(
                p.detach().float().numpy().astype(
                    "float32" if not bf16 else np.float32))
            if bf16:
                ref.state_dict()[n].set_value(
                    ref.state_dict()[n]._value.astype("bfloat16"))
        back = ref_state.capture_optimizer(ref_opt)
    for slot, arr in data["flat_stores"].items():
        assert np.array_equal(np.asarray(back["flat_stores"][slot]), arr)
    for k, arr in data["accumulators"].items():  # the masters
        assert np.array_equal(np.asarray(back["accumulators"][k]), arr), k
    assert sorted(back["accumulators"]) == sorted(data["accumulators"])
    assert bool(back["step_count"] == data["step_count"])
    _ref_steps(ref, ref_opt, _xs(2, 2))
    _port_steps(port, port_opt, _xs(2, 2))
    # bf16: the float32 masters (the parameters are their casts, which may
    # round apart where the masters differ by rounding)
    for n, p in port.named_parameters():
        rp = ref.state_dict()[n]
        if bf16:
            got = port_opt._accumulators[("master", id(p))]
            want = ref_opt._accumulators[("master", id(rp))]._value
        else:
            got, want = p, rp._value
        want = np.asarray(want, np.float32)
        tol = (dict(rtol=0.0, atol=2 ** -8 * float(np.abs(want).max()))
               if bf16 else F32)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   **tol, err_msg=n)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_fused_and_unfused_records_do_not_mix(package):
    import paddle_tpu as paddle
    from paddle_tpu.checkpoint import state as ref_state
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.checkpoint import state as port_state
    if package == "reference":
        m = _ref_mlp()
        make = lambda fused: paddle.optimizer.Adam(  # noqa: E731
            parameters=m.parameters(), fuse_accumulators=fused)
        st = ref_state
    else:
        m = _mlp()
        make = lambda fused: optimizer.Adam(  # noqa: E731
            parameters=m.parameters(), fuse_accumulators=fused)
        st = port_state
    fused, plain = make(True), make(False)
    with pytest.raises(st.StateMismatchError):
        st.restore_optimizer(plain, st.capture_optimizer(fused))
    with pytest.raises(st.StateMismatchError):
        st.restore_optimizer(fused, st.capture_optimizer(plain))


def test_gradient_merge_and_owner_sharding_refuse_a_fused_optimizer():
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        GradientMergeOptimizer, shard_optimizer_state)
    m = _mlp()
    opt = optimizer.Adam(parameters=m.parameters(), fuse_accumulators=True)
    with pytest.raises(NotImplementedError, match="fuse_accumulators"):
        GradientMergeOptimizer(opt, k_steps=2)
    with pytest.raises(NotImplementedError, match="fuse_accumulators"):
        shard_optimizer_state(opt, mesh=None)


def test_state_ledger_counts_each_store_once():
    """The ledger's moment bytes are the two stores' (the reference's fused
    stores have the same ``[rows, 1024]`` shape), not the views' again."""
    import paddle_tpu as paddle
    import gc
    from paddle_tpu_torch.observability import memory
    gc.collect()  # the optimizers of earlier tests leave the ledger
    m = _mlp()
    opt = _opt("adam", m.parameters(), True)
    led = memory.state_ledger()
    mine = [e for e in led["entries"] if e["name"].startswith("fused_")]
    assert sorted(e["name"] for e in mine) == ["fused_moment1",
                                                "fused_moment2"]
    assert not any(e["name"].endswith(".moment1") for e in led["entries"])
    rows = opt._fused.layout.rows
    assert all(e["bytes"] == rows * 1024 * 4 for e in mine)
    ref = _ref_mlp()
    ref_opt = paddle.optimizer.Adam(parameters=ref.parameters(),
                                    fuse_accumulators=True)
    shapes = sorted(tuple(s.tensor._value.shape)
                    for s in ref_opt._flat_stores.values())
    assert shapes == [(rows, 1024)] * 2
