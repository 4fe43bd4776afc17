"""The fleet's meta-optimizers in the port against the reference's
(``tests/test_meta_optimizers.py``'s cases, ported) and on a dp = 2 gloo
world.

- Every strategy switch resolves to the reference's stack names
  (``StrategyCompiler``, both packages on the same strategies); DGC needs
  a Momentum (warning otherwise); dgc and localsgd conflict (dgc wins);
  lamb rebuilds an Adam as ``Lamb``; ``adaptive_localsgd`` selects nothing
  and raises nothing.
- DGC before its rampup is ``Momentum`` bitwise; after it, the top-k
  update with error feedback, step by step against the reference's from
  the same parameters and gradients (float32 rtol 1e-5 / atol 1e-6), and
  ties at the threshold pass (``>=``).
- FP16AllReduce quantizes each gradient through float16 exactly; the AMP
  meta-optimizer's scaled step equals the unscaled SGD step (1e-6
  relative) and the reference's (1e-5); ASP's masks equal the reference's
  and survive steps; ``apply_recompute`` wraps the named layers once and
  their gradients are bitwise the plain model's.
- Gradient merge over k micro-steps (``avg=True``) is one big-batch step
  of the plain optimizer (the mean gradient), against the reference's
  merge too (rtol 1e-5 / atol 1e-6).
- At dp = 2 over gloo (``file://`` rendezvous under ``tmp_path``; each rank
  destroys its groups at the end), through ``fleet.distributed_optimizer``
  on half the batch each, against the replicated whole-batch step of the
  plain optimizer in the rank (1e-5 relative: the mean of two half-batch
  means against one whole-batch mean): localsgd (``k_steps=2``), whose
  parameter all-reduces run on the boundary steps only; fp16_allreduce;
  sharding stage 1 and 2 with Adam; lamb with sharding on the
  owner-per-parameter path; sharding with gradient merge (ZeRO's stores
  roll back with the rest). The reference's own sharding with gradient
  merge at dp 2 misses its big-batch step (ROADMAP §3, F13); its plain
  gradient merge meets it.
"""
import warnings

import numpy as np
import pytest
import torch

from test_torch_hybrid import fleet_init, spawn

F32 = dict(rtol=1e-5, atol=1e-6)
DP_REL = 1e-5
WHOLE, K = 8, 2  # the whole batch; the merge window


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _weights():
    rng = np.random.RandomState(0)
    return {"0.weight": rng.randn(8, 16).astype("float32") * 0.3,
            "0.bias": rng.randn(16).astype("float32") * 0.1,
            "2.weight": rng.randn(16, 4).astype("float32") * 0.3,
            "2.bias": rng.randn(4).astype("float32") * 0.1}


def _data(n=WHOLE, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 8).astype("float32"),
            rng.rand(n, 4).astype("float32"))


def _port_model():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.bridge import load_reference_state
    m = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                      nn.Linear(16, 4, device="cpu"))
    load_reference_state(m, _weights())
    return m


def _ref_model():
    import paddle_tpu as paddle
    m = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                             paddle.nn.Linear(16, 4))
    for k, v in _weights().items():
        m.state_dict()[k].set_value(v)
    return m


def _port_loss(m, x, y):
    from paddle_tpu_torch.nn import functional as F
    return F.mse_loss(m(torch.from_numpy(x)), torch.from_numpy(y))


def _ref_loss(m, x, y):
    import paddle_tpu as paddle
    return paddle.nn.functional.mse_loss(m(paddle.to_tensor(x)),
                                         paddle.to_tensor(y))


def _port_weights(m):
    return {n: p.detach().clone().numpy() for n, p in m.named_parameters()}


def _ref_weights(m):
    return {n: np.asarray(p._value) for n, p in m.state_dict().items()}


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], **(tol or F32),
                                   err_msg=n)


# -- the stack --------------------------------------------------------------

STRATEGIES = {
    "each": dict(gradient_merge=True, fp16_allreduce=True, amp=True,
                 asp=True),
    "dgc": dict(dgc=True),
    "dgc_localsgd": dict(dgc=True, localsgd=True),
    "lars": dict(lars=True),
    "lamb": dict(lamb=True),
    "lamb_gm_amp": dict(lamb=True, gradient_merge=True, amp=True),
    "localsgd": dict(localsgd=True),
    "adaptive_localsgd": dict(adaptive_localsgd=True),
    "nothing": dict(),
}
INNER = {"momentum": "Momentum", "adam": "Adam", "sgd": "SGD"}


def _names(pkg, fields, inner):
    opt_mod = pkg.optimizer
    if pkg.__name__ == "paddle_tpu":
        m = _ref_model()
        from paddle_tpu.distributed import fleet
        from paddle_tpu.distributed.fleet.meta_optimizers import (
            StrategyCompiler)
    else:
        m = _port_model()
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
            StrategyCompiler)
    s = fleet.DistributedStrategy()
    for k, v in fields.items():
        setattr(s, k, v)
    opt = getattr(opt_mod, INNER[inner])(parameters=m.parameters())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stack = StrategyCompiler().resolve(s, None, opt)
    return ([n for n, _ in stack], sorted(str(x.message) for x in w),
            type(StrategyCompiler.apply(stack, opt)).__name__)


@pytest.mark.parametrize("inner", sorted(INNER))
@pytest.mark.parametrize("case", sorted(STRATEGIES))
def test_each_strategy_resolves_to_the_reference_stack(case, inner):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    want = _names(paddle, STRATEGIES[case], inner)
    got = _names(pt, STRATEGIES[case], inner)
    assert got == want


def test_the_reference_cases_of_the_stack():
    import paddle_tpu_torch as pt
    names, warned, cls = _names(pt, STRATEGIES["each"], "momentum")
    assert names == ["fp16_allreduce", "gradient_merge", "asp", "amp"]
    names, warned, _ = _names(pt, {"dgc": True}, "adam")
    assert names == [] and any("Momentum" in w for w in warned)
    names, warned, _ = _names(pt, STRATEGIES["dgc_localsgd"], "momentum")
    assert names == ["dgc"] and any("conflicts" in w for w in warned)
    assert _names(pt, {"lamb": True}, "adam")[2] == "Lamb"
    assert _names(pt, {"adaptive_localsgd": True}, "adam")[0] == []


# -- DGC -----------------------------------------------------------------------

def _grads(step, shapes):
    rng = np.random.RandomState(300 + step)
    return {n: (rng.randn(*s) * 0.5).astype("float32")
            for n, s in shapes.items()}


def test_dgc_rampup_is_momentum_bitwise():
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer)
    a, b = _port_model(), _port_model()
    dgc = DGCMomentumOptimizer(learning_rate=0.1, momentum=0.9,
                               rampup_begin_step=100,
                               parameters=a.parameters())
    mom = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=b.parameters())
    x, y = _data()
    for _ in range(3):
        for m, opt in ((a, dgc), (b, mom)):
            _port_loss(m, x, y).backward()
            opt.step()
            opt.clear_grad()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("nesterov", [False, True])
def test_dgc_topk_with_error_feedback_matches_reference(nesterov):
    """Rampup until step 1, then sparsity 0.75: each step's parameters and
    the three slots against the reference's."""
    import jax.numpy as jnp
    from paddle_tpu.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer as RefDGC)
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer)
    ref, port = _ref_model(), _port_model()
    kw = dict(learning_rate=0.1, momentum=0.9, rampup_begin_step=1,
              sparsity=[0.75], use_nesterov=nesterov)
    ref_opt = RefDGC(parameters=ref.parameters(), **kw)
    port_opt = DGCMomentumOptimizer(parameters=port.parameters(), **kw)
    rp = dict(ref.state_dict())
    pp = dict(port.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in pp.items()}
    for step in range(4):
        g = _grads(step, shapes)
        for n in shapes:
            rp[n]._grad = jnp.asarray(g[n])
            pp[n].grad = torch.from_numpy(g[n])
        ref_opt.step()
        port_opt.step()
        _close(_port_weights(port), _ref_weights(ref))
        for n in shapes:
            for slot in ("dgc_u", "dgc_v", "velocity"):
                np.testing.assert_allclose(
                    port_opt._get_accumulator(slot, pp[n]).numpy(),
                    np.asarray(ref_opt._get_accumulator(slot,
                                                        rp[n])._value),
                    **F32, err_msg=f"{step} {n} {slot}")
    delta = port_opt._get_accumulator("dgc_v", pp["0.weight"])
    assert float(delta.abs().sum()) > 0  # the skipped mass is kept


def test_dgc_ties_at_the_threshold_pass():
    """Equal magnitudes everywhere: the k-th largest equals every |v|, so
    every entry passes ``>=`` and the whole gradient is applied."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer)
    p = torch.nn.Parameter(torch.zeros(64))
    opt = DGCMomentumOptimizer(learning_rate=1.0, momentum=0.0,
                               rampup_begin_step=0, sparsity=[0.9],
                               parameters=[p])
    p.grad = torch.where(torch.arange(64) % 2 == 0, 1.0, -1.0)
    opt.step()
    assert int((p != 0).sum()) == 64
    assert float(opt._get_accumulator("dgc_v", p).abs().sum()) == 0.0


# -- fp16, amp, asp, recompute --------------------------------------------------

def test_fp16_allreduce_quantizes_through_float16():
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        FP16AllReduceOptimizer)
    m = _port_model()
    opt = FP16AllReduceOptimizer(optimizer.SGD(learning_rate=0.0,
                                               parameters=m.parameters()))
    x, y = _data()
    _port_loss(m, x, y).backward()
    g32 = m[0].weight.grad.clone()
    opt._quantize_grads()
    assert m[0].weight.grad.dtype == torch.float32
    assert torch.equal(m[0].weight.grad, g32.half().float())


def test_amp_scaled_step_is_the_unscaled_step():
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.meta_optimizers import (
        AMPOptimizer as RefAMP)
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        AMPOptimizer)
    x, y = _data()
    m = _port_model()
    amp = AMPOptimizer(optimizer.SGD(learning_rate=0.1,
                                     parameters=m.parameters()),
                       {"init_loss_scaling": 1024.0})
    amp.minimize(_port_loss(m, x, y))
    plain = _port_model()
    sgd = optimizer.SGD(learning_rate=0.1, parameters=plain.parameters())
    _port_loss(plain, x, y).backward()
    sgd.step()
    _close(_port_weights(m), _port_weights(plain), rtol=1e-6, atol=1e-7)
    ref = _ref_model()
    RefAMP(paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=ref.parameters()),
           {"init_loss_scaling": 1024.0}).minimize(_ref_loss(ref, x, y))
    _close(_port_weights(m), _ref_weights(ref))


def test_asp_masks_equal_the_reference_and_survive_steps():
    from paddle_tpu.sparsity import prune_model as ref_prune
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        ASPOptimizer)
    from paddle_tpu_torch.sparsity import check_mask_1d, prune_model
    m, ref = _port_model(), _ref_model()
    prune_model(m)
    ref_prune(ref)
    _close(_port_weights(m), _ref_weights(ref), rtol=0, atol=0)
    opt = ASPOptimizer(optimizer.SGD(learning_rate=0.1,
                                     parameters=m.parameters()))
    x, y = _data()
    for _ in range(3):
        _port_loss(m, x, y).backward()
        opt.step()
        opt.clear_grad()
    assert check_mask_1d(m[0].weight, 2, 4) and check_mask_1d(
        m[2].weight, 2, 4)
    assert not check_mask_1d(m[0].bias.reshape(4, 4) + 1, 2, 4)


def test_apply_recompute_wraps_once_and_trains_bitwise():
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        apply_recompute)
    m, plain = _port_model(), _port_model()
    assert apply_recompute(m, ["0", "2"]) == ["0", "2"]
    assert apply_recompute(m, ["0", "2"]) == []  # never twice
    x, y = _data()
    _port_loss(m, x, y).backward()
    _port_loss(plain, x, y).backward()
    for (n, p), q in zip(m.named_parameters(), plain.parameters()):
        assert torch.equal(p.grad, q.grad), n


# -- gradient merge -------------------------------------------------------------

def _merge_port(k, windows, make):
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        GradientMergeOptimizer)
    m = _port_model()
    opt = GradientMergeOptimizer(make(m.parameters()), k_steps=k, avg=True)
    x, y = _data(WHOLE * windows, seed=4)
    per = WHOLE // k
    for i in range(k * windows):
        _port_loss(m, x[i * per:(i + 1) * per],
                   y[i * per:(i + 1) * per]).backward()
        opt.step()
        opt.clear_grad()
    return _port_weights(m), opt


def _big_batch_port(windows, make):
    m = _port_model()
    opt = make(m.parameters())
    x, y = _data(WHOLE * windows, seed=4)
    for w in range(windows):
        _port_loss(m, x[w * WHOLE:(w + 1) * WHOLE],
                   y[w * WHOLE:(w + 1) * WHOLE]).backward()
        opt.step()
        opt.clear_grad()
    return _port_weights(m), opt


@pytest.mark.parametrize("inner", ["Adam", "Momentum", "Lamb"])
def test_gradient_merge_window_is_one_big_batch_step(inner):
    """Windows of K micro-steps of WHOLE/K samples: every piece of state
    (moments, ``@step``) advances once a window, to the big-batch step's
    values (the mean of K micro means against one mean: 1e-5)."""
    from paddle_tpu_torch import optimizer
    make = lambda ps: getattr(optimizer, inner)(  # noqa: E731
        learning_rate=0.05, parameters=ps)
    got, gm = _merge_port(K, 3, make)
    want, plain = _big_batch_port(3, make)
    _close(got, want)
    assert int(gm._step_count) == int(plain._step_count) == 3
    assert int(gm._merge_step) == 3 * K


def test_gradient_merge_matches_the_reference():
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.meta_optimizers import (
        GradientMergeOptimizer as RefGM)
    from paddle_tpu_torch import optimizer
    got, _ = _merge_port(K, 2, lambda ps: optimizer.Adam(
        learning_rate=0.05, parameters=ps))
    ref = _ref_model()
    opt = RefGM(paddle.optimizer.Adam(learning_rate=0.05,
                                      parameters=ref.parameters()),
                k_steps=K, avg=True)
    x, y = _data(WHOLE * 2, seed=4)
    per = WHOLE // K
    for i in range(K * 2):
        _ref_loss(ref, x[i * per:(i + 1) * per],
                  y[i * per:(i + 1) * per]).backward()
        opt.step()
        opt.clear_grad()
    _close(got, _ref_weights(ref))


# -- dp = 2 over gloo ----------------------------------------------------------

def _dp_arm(fields, make, steps, rank, world):
    """``fleet.distributed_optimizer(make(params))`` under ``fields`` on
    this rank's half of each batch: (stack names, weights, the all-reduce
    calls of each step)."""
    from paddle_tpu_torch.distributed import collective, fleet
    fleet_init(dp=world, **fields)
    m = _port_model()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        opt = fleet.distributed_optimizer(make(m.parameters()))
    x, y = _data(WHOLE * steps, seed=7)
    half = WHOLE // world
    calls = []
    for s in range(steps):
        lo = s * WHOLE + rank * half
        collective.reset_counts()
        _port_loss(m, x[lo:lo + half], y[lo:lo + half]).backward()
        opt.step()
        opt.clear_grad()
        calls.append(collective.counts().get("all_reduce", (0, 0))[0])
    return {"names": opt._meta_optimizer_names, "weights": _port_weights(m),
            "calls": calls, "warned": [str(x.message) for x in w]}


def _whole(make, steps, window=1):
    """The plain optimizer on the whole batch (a window's samples as one
    batch), in this process."""
    m = _port_model()
    opt = make(m.parameters())
    x, y = _data(WHOLE * steps, seed=7)
    span = WHOLE * window
    for s in range(steps // window):
        _port_loss(m, x[s * span:(s + 1) * span],
                   y[s * span:(s + 1) * span]).backward()
        opt.step()
        opt.clear_grad()
    return _port_weights(m)


def _adam(ps):
    from paddle_tpu_torch import optimizer
    return optimizer.Adam(learning_rate=0.05, parameters=ps)


def _sgd(ps):
    from paddle_tpu_torch import optimizer
    return optimizer.SGD(learning_rate=0.1, parameters=ps)


DP_ARMS = {
    # name: (strategy fields, optimizer, steps, merge window)
    "localsgd": (dict(localsgd=True, localsgd_configs={"k_steps": 2}),
                 _sgd, 4, 1),
    "fp16_allreduce": (dict(fp16_allreduce=True), _sgd, 2, 1),
    "sharding1": (dict(sharding=True, sharding_configs={"stage": 1}),
                  _adam, 3, 1),
    "sharding2": (dict(sharding=True, sharding_configs={"stage": 2}),
                  _adam, 3, 1),
    "lamb_sharding": (dict(lamb=True, sharding=True), _adam, 3, 1),
    "sharding_gradient_merge": (
        dict(sharding=True, gradient_merge=True,
             gradient_merge_configs={"k_steps": 2, "avg": True}),
        _adam, 4, 2),
    "adaptive_localsgd": (dict(adaptive_localsgd=True), _sgd, 2, 1),
}


def rank_task(task, inputs, rank, world):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import parallel_env
    out = {}
    for name, (fields, make, steps, window) in DP_ARMS.items():
        out[name] = _dp_arm(fields, make, steps, rank, world)
        if name == "fp16_allreduce":  # the whole batch's gradient too
            from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
                FP16AllReduceOptimizer)
            make = lambda ps: FP16AllReduceOptimizer(_sgd(ps))  # noqa: E731
        if name == "lamb_sharding":
            make = lambda ps: optimizer.Lamb(  # noqa: E731
                learning_rate=0.05, lamb_weight_decay=0.01, epsilon=1e-8,
                parameters=ps)
        out[name]["whole"] = _whole(make, steps, window)
    parallel_env.destroy_parallel_env()
    return out


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("meta_dp2"), 2,
                 "test_torch_meta_optimizers", "dp2", {})


@pytest.mark.parametrize("arm", sorted(DP_ARMS))
def test_dp2_arm_is_the_whole_batch_step(dp2, arm):
    for rank in dp2:
        got = rank[arm]
        for n, w in got["whole"].items():
            a, b = got["weights"][n].astype(np.float64), w.astype(np.float64)
            assert np.linalg.norm(a - b) <= DP_REL * np.linalg.norm(b), n
    a, b = dp2
    for n in a[arm]["weights"]:  # the ranks agree exactly
        assert np.array_equal(a[arm]["weights"][n], b[arm]["weights"][n])


def test_dp2_stacks_and_collectives(dp2):
    r0 = dp2[0]
    assert r0["localsgd"]["names"] == ["localsgd"]
    # one gradient bucket a step; the four parameters' averages on the
    # boundary steps (2 and 4) only
    assert r0["localsgd"]["calls"] == [1, 5, 1, 5]
    assert r0["lamb_sharding"]["names"] == ["lamb", "sharding"]
    assert any("owner" in w for w in r0["lamb_sharding"]["warned"])
    assert r0["sharding1"]["names"] == ["sharding"]
    assert r0["sharding_gradient_merge"]["names"] == ["sharding",
                                                      "gradient_merge"]
    assert r0["adaptive_localsgd"]["names"] == []
