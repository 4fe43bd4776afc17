"""The eleven optimizers of the reference's tail in the port (``Adagrad``,
``RMSProp``, ``Adadelta``, ``Adamax``, ``DecayedAdagrad``, ``ProximalGD``,
``ProximalAdagrad``, ``Ftrl``, ``Lamb``, ``Lars``, ``Dpsgd``) against
``paddle_tpu.optimizer``: the same parameters and gradients (numpy, from a
seed) through both packages for 5 steps, the parameters and every slot
(the ``state_dict``, keys and values), ``@step`` and ``@lr`` compared
after every step; with L2 and L1 ``weight_decay``, a per-parameter
``regularizer``, ``grad_clip``, parameter groups, a scheduler as the rate
and a ``state_dict`` carried from the reference into the port halfway.

At dp = 2 over gloo (ranks this file spawns), each elementwise optimizer
under ZeRO-1, 2 and 3 is bitwise the port's replicated step (the mean
gradient, ``fused_allreduce_grads``), which is held against the
reference's eager step on the same mean gradient.

Tolerances: float32 rtol 1e-5 / atol 1e-6, as ``test_torch_optimizer.py``
(the same float32 update; ``beta ** t`` from the step count may differ by
an ulp between ``torch.pow`` and XLA's ``pow``, and so may ``x ** 0.5``,
which torch takes as a square root). ``Dpsgd`` runs at ``sigma = 0``
against the reference (threefry and Philox never agree); its noise is
checked by its moments under a seed and for reproducibility.
"""
import numpy as np
import pytest
import torch

from test_torch_hybrid import spawn

STEPS = 5
# test_torch_optimizer's parameters (the ranks import this file, and no JAX)
SHAPES = {"fc.weight": (8, 6), "fc.bias": (6,), "ln.weight": (6,)}
F32 = dict(rtol=1e-5, atol=1e-6)
ELEMENTWISE = {
    # name: kwargs for both packages
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5, centered=True),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "Adamax": dict(learning_rate=0.02),
    "DecayedAdagrad": dict(learning_rate=0.1, decay=0.9),
    "ProximalGD": dict(learning_rate=0.05, l1=0.01, l2=0.02),
    "ProximalAdagrad": dict(learning_rate=0.1, l1=0.01, l2=0.02),
    "Ftrl": dict(learning_rate=0.1, l1=0.05, l2=0.0),
}
WHOLE = {
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.02),
    "Lars": dict(learning_rate=0.1, momentum=0.9, lars_coeff=0.01,
                 lars_weight_decay=0.001),
    "Dpsgd": dict(learning_rate=0.1, clip=0.5, batch_size=4.0, sigma=0.0),
}
ALL = {**ELEMENTWISE, **WHOLE}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _values(seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype("float32") for n, s in SHAPES.items()}


def _make(dtype):
    from test_torch_optimizer import _make as make
    return make(dtype)


def _set_grads(ref, port, step, scale=0.5):
    from test_torch_optimizer import _set_grads as set_grads
    set_grads(ref, port, step, scale)


def _compare(ref, port, ref_opt, port_opt):
    from test_torch_optimizer import _compare as compare
    compare(ref, port, ref_opt, port_opt)


def _both(name, ref, port, ref_kw=None, port_kw=None, **kw):
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    ref_opt = getattr(paddle.optimizer, name)(
        parameters=ref, **ALL[name], **kw, **(ref_kw or {}))
    port_opt = getattr(optimizer, name)(
        parameters=port, **ALL[name], **kw, **(port_kw or {}))
    return ref_opt, port_opt


def _run(ref, port, ref_opt, port_opt, steps=STEPS, first=0, scale=0.5,
         scheds=()):
    for step in range(first, first + steps):
        _set_grads(ref, port, step, scale)
        ref_opt.step()
        port_opt.step()
        ref_opt.clear_grad()
        port_opt.clear_grad()
        for s in scheds:
            s.step()
        _compare(ref, port, ref_opt, port_opt)


@pytest.mark.parametrize("name", sorted(ALL))
def test_optimizer_matches_reference(name):
    ref, port = _make("float32")
    _run(ref, port, *_both(name, ref, port))


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
@pytest.mark.parametrize("decay", ["l2", "l1"])
def test_weight_decay_matches_reference(name, decay):
    import paddle_tpu as paddle
    from paddle_tpu_torch import regularizer
    cls = "L2Decay" if decay == "l2" else "L1Decay"
    ref, port = _make("float32")
    _run(ref, port, *_both(
        name, ref, port,
        ref_kw={"weight_decay": getattr(paddle.regularizer, cls)(0.05)},
        port_kw={"weight_decay": getattr(regularizer, cls)(0.05)}))


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_regularizer_clip_groups_and_scheduler(name):
    """A per-parameter L2 regularizer on one weight (beside a float
    ``weight_decay``), a global-norm clip that binds, two parameter groups
    and a ``StepDecay`` rate."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import nn, optimizer, regularizer
    ref, port = _make("float32")
    ref[0].regularizer = paddle.regularizer.L2Decay(0.1)
    port[0].regularizer = regularizer.L2Decay(0.1)
    lr = ALL[name]["learning_rate"]
    ref_s = paddle.optimizer.lr.StepDecay(lr, step_size=2, gamma=0.5)
    port_s = optimizer.lr.StepDecay(lr, step_size=2, gamma=0.5)
    kw = {k: v for k, v in ALL[name].items() if k != "learning_rate"}
    ref_opt = getattr(paddle.optimizer, name)(
        learning_rate=ref_s, weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.3),
        parameters=[{"params": ref[:2]}, {"params": ref[2:]}], **kw)
    port_opt = getattr(optimizer, name)(
        learning_rate=port_s, weight_decay=0.01,
        grad_clip=nn.ClipGradByGlobalNorm(0.3),
        parameters=[{"params": port[:2]}, {"params": port[2:]}], **kw)
    _run(ref, port, ref_opt, port_opt, scheds=(ref_s, port_s))


@pytest.mark.parametrize("name", sorted(ALL))
def test_state_dict_crosses_from_the_reference(name):
    """Three steps on the reference; its ``state_dict`` into a fresh port
    optimizer over the reference's parameter values; two more steps on
    both."""
    from paddle_tpu_torch.bridge import load_reference_optimizer_state
    ref, port = _make("float32")
    ref_opt, _ = _both(name, ref, port)
    for step in range(3):
        _set_grads(ref, port, step)
        ref_opt.step()
        ref_opt.clear_grad()
    with torch.no_grad():
        for r, p in zip(ref, port):
            p.copy_(torch.from_numpy(np.array(r._value)))
    _, port_opt = _both(name, ref, port)
    state = {k: np.asarray(v.numpy()) for k, v in ref_opt.state_dict()
             .items() if k != "LR_Scheduler"}
    load_reference_optimizer_state(port_opt, state, {n: n for n in SHAPES})
    _compare(ref, port, ref_opt, port_opt)
    _run(ref, port, ref_opt, port_opt, steps=2, first=3)


def test_rmsprop_plain_and_adagrad_start_value():
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    for name, kw in (("RMSProp", dict(learning_rate=0.01)),
                     ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
                     ("Adagrad", dict(learning_rate=0.1,
                                      initial_accumulator_value=0.7))):
        ref, port = _make("float32")
        ref_opt = getattr(paddle.optimizer, name)(parameters=ref, **kw)
        port_opt = getattr(optimizer, name)(parameters=port, **kw)
        if name == "Adagrad":
            assert float(port_opt.state_dict()["fc.bias.moment"][0]) \
                == float(np.float32(0.7))
        _run(ref, port, ref_opt, port_opt)


def test_ftrl_weights_land_exactly_on_zero():
    """``l1`` larger than every accumulated ``|linear|`` of some entries:
    those weights are exactly 0 on both sides, with no NaN from the branch
    not taken (``l2 = 0``, zero gradients on one parameter)."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    ref, port = _make("float32")
    ref_opt = paddle.optimizer.Ftrl(0.1, l1=0.3, parameters=ref)
    port_opt = optimizer.Ftrl(0.1, l1=0.3, parameters=port)
    for step in range(3):
        _set_grads(ref, port, step, scale=0.2)
        import jax.numpy as jnp
        ref[2]._grad = jnp.zeros_like(ref[2]._value)
        port[2].grad = torch.zeros_like(port[2])
        ref_opt.step()
        port_opt.step()
        _compare(ref, port, ref_opt, port_opt)
    values = torch.cat([p.detach().reshape(-1) for p in port])
    assert bool(torch.isfinite(values).all())
    assert int((values == 0).sum()) > 0
    assert bool((port[2] == 0).all())  # no history: every weight exactly 0


def test_lamb_exclusion_reads_the_structured_name():
    """``exclude_from_weight_decay_fn`` receives the parameter with its
    structured name as ``name``; against the reference with a function of
    the shape (the reference's names are its auto names)."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    seen = []
    ref, port = _make("float32")
    optimizer.Lamb(parameters=port, exclude_from_weight_decay_fn=lambda p: (
        seen.append(p.name) or "bias" in p.name))
    assert seen == list(SHAPES)
    ref, port = _make("float32")
    ref_opt = paddle.optimizer.Lamb(
        0.01, parameters=ref,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)
    port_opt = optimizer.Lamb(
        0.01, parameters=port,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)
    _run(ref, port, ref_opt, port_opt)


def test_lars_ignores_its_exclusion_as_the_reference():
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    ref, port = _make("float32")
    kw = dict(WHOLE["Lars"], exclude_from_weight_decay=["bias"])
    _run(ref, port, paddle.optimizer.Lars(parameters=ref, **kw),
         optimizer.Lars(parameters=port, **kw))


def test_dpsgd_noise_moments_and_reproducibility():
    """Zero gradients: the update is ``-lr * noise``, noise of scale
    ``sigma / batch_size``; its mean and variance over 20000 draws within
    5 standard errors, and the same seed gives the same draws."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer

    def draws(seed):
        pt.seed(seed)
        p = torch.nn.Parameter(torch.zeros(20000))
        opt = optimizer.Dpsgd(learning_rate=1.0, sigma=2.0, batch_size=4.0,
                              parameters=[p])
        p.grad = torch.zeros_like(p)
        opt.step()
        return -p.detach().double()

    a, b, c = draws(5), draws(5), draws(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    sd, n = 0.5, a.numel()
    assert abs(float(a.mean())) <= 5 * sd / n ** 0.5
    assert abs(float(a.var()) - sd ** 2) <= 5 * sd ** 2 * (2 / n) ** 0.5


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_whole_tensor_optimizers_refuse_zero(name):
    ref, port = _make("float32")
    _, opt = _both(name, ref, port)
    with pytest.raises(NotImplementedError, match="cannot run sharded"):
        opt._zero_enable(axis="dp", stage=1)


# -- ZeRO at dp = 2 over gloo -------------------------------------------------

def _rank_grads(step, rank):
    rng = np.random.RandomState(1000 * step + 17 * rank)
    return {n: (rng.randn(*s) * 0.5).astype("float32")
            for n, s in SHAPES.items()}


def _zero_arm(name, stage):
    """Three steps of ``name`` on this rank's gradients: replicated
    (``stage == 0``: the mean by ``fused_allreduce_grads``) or ZeRO."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective, parallel_env
    from paddle_tpu_torch.distributed.parallel import fused_allreduce_grads
    rank = collective.get_rank()
    params = []
    for n, v in _values(0).items():
        p = torch.nn.Parameter(torch.from_numpy(v.copy()))
        p.param_name = n
        params.append(p)
    opt = getattr(optimizer, name)(parameters=params, **ALL[name])
    group = parallel_env.axis_group(parallel_env.current_mesh(), "dp")
    if stage:
        opt._zero_enable(axis="dp", stage=stage, comm_buffer_mb=1e-3)
    for step in range(3):
        for p in params:
            p.grad = torch.from_numpy(_rank_grads(step, rank)[p.param_name])
        if not stage:
            fused_allreduce_grads(params, group=group)
        opt.step()
        opt.clear_grad()
    return {p.param_name: p.detach().clone().numpy() for p in params}


def rank_task(task, inputs, rank, world):
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": world}))
    return {name: {stage: _zero_arm(name, stage) for stage in (0, 1, 2, 3)}
            for name in sorted(ELEMENTWISE)}


@pytest.fixture(scope="module")
def zero_ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("zero_breadth"), 2,
                 "test_torch_optimizers_breadth", "zero", {})


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_zero_is_bitwise_the_replicated_step_at_dp2(zero_ranks, name):
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.core.tensor import Parameter as RefParameter
    for rank in zero_ranks:
        arms = rank[name]
        for stage in (1, 2, 3):
            for n, w in arms[0].items():
                assert np.array_equal(arms[stage][n], w), (stage, n)
    ref = [RefParameter(jnp.asarray(v), name=n)
           for n, v in _values(0).items()]
    opt = getattr(paddle.optimizer, name)(parameters=ref, **ALL[name])
    for step in range(3):
        g0, g1 = _rank_grads(step, 0), _rank_grads(step, 1)
        for r in ref:
            r._grad = jnp.asarray((g0[r.name] + g1[r.name])
                                  / np.float32(2))
        opt.step()
        opt.clear_grad()
    for r in ref:
        np.testing.assert_allclose(zero_ranks[0][name][0][r.name],
                                   np.asarray(r._value), **F32,
                                   err_msg=r.name)
