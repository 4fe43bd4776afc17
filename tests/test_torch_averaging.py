"""Parameter averaging in the port against ``paddle_tpu.optimizer.
averaging``: ``ModelAverage`` with small windows (its restarts, and the
parameters ``apply`` writes and ``restore`` puts back),
``ExponentialMovingAverage`` with and without ``thres_steps``, and
``LookAhead(k=3)`` around ``Adam`` over seven steps, from the same
parameters and gradients (numpy, from a seed); float32 rtol 1e-5 /
atol 1e-6 (the same float32 math in another library).

The masters finding (ROADMAP §3, F14): under
``multi_precision`` the reference's LookAhead writes the bf16 parameter
only, and the inner optimizer's float32 master, from which the next step
computes the parameter, undoes the reset; its ASP masks likewise come back
through the master. Both are shown on the reference here; the port writes
the master too, so the reset and the mask stick.
"""
import numpy as np
import pytest
import torch

F32 = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"fc.weight": (8, 6), "fc.bias": (6,)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pair(dtype="float32"):
    import jax.numpy as jnp
    from paddle_tpu.core.tensor import Parameter as RefParameter
    rng = np.random.RandomState(0)
    vals = {n: rng.randn(*s).astype("float32") for n, s in SHAPES.items()}
    ref = [RefParameter(jnp.asarray(v).astype(dtype), name=n)
           for n, v in vals.items()]
    port = []
    for n, v in vals.items():
        p = torch.nn.Parameter(torch.from_numpy(v).to(getattr(torch, dtype)))
        p.param_name = n
        port.append(p)
    return ref, port


def _grads(ref, port, step):
    import jax.numpy as jnp
    for i, (r, p) in enumerate(zip(ref, port)):
        g = (np.random.RandomState(100 * step + i).randn(*p.shape)
             * 0.5).astype("float32")
        r._grad = jnp.asarray(g).astype(r._value.dtype)
        p.grad = torch.from_numpy(g).to(p.dtype)


def _same(ref, port, **tol):
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(r._value, np.float32),
                                   **(tol or F32), err_msg=p.param_name)


def _sgd_steps(ref, port, ref_opt, port_opt, step):
    _grads(ref, port, step)
    ref_opt.step()
    port_opt.step()
    ref_opt.clear_grad()
    port_opt.clear_grad()


@pytest.mark.parametrize("windows", [(2, 3, 0.5), (3, 5, 0.3)])
def test_model_average_windows_apply_and_restore(windows):
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    lo, hi, rate = windows
    ref, port = _pair()
    ref_sgd = paddle.optimizer.SGD(0.1, parameters=ref)
    port_sgd = optimizer.SGD(0.1, parameters=port)
    kw = dict(average_window_rate=rate, min_average_window=lo,
              max_average_window=hi)
    ref_ma = paddle.optimizer.ModelAverage(parameters=ref, **kw)
    port_ma = optimizer.ModelAverage(parameters=port, **kw)
    for step in range(9):
        _sgd_steps(ref, port, ref_sgd, port_sgd, step)
        ref_ma.step()
        port_ma.step()
        for a, b in (("_num_accum", "_num_accum"),
                     ("_old_num_accum", "_old_num_accum")):
            assert float(getattr(port_ma, a)) == float(
                getattr(ref_ma, b)._value), (step, a)
        live = [p.detach().clone() for p in port]
        with ref_ma.apply(), port_ma.apply():
            _same(ref, port)
        _same(ref, port)
        for p, q in zip(port, live):
            assert torch.equal(p, q)  # restored bitwise


def test_model_average_without_restore_and_before_any_step():
    from paddle_tpu_torch import optimizer
    _, port = _pair()
    ma = optimizer.ModelAverage(parameters=port, min_average_window=2,
                                max_average_window=4)
    live = [p.detach().clone() for p in port]
    with ma.apply():  # nothing accumulated: the parameters stay
        for p, q in zip(port, live):
            assert torch.equal(p, q)
    ma.step()
    with torch.no_grad():
        port[0].add_(1.0)
    with ma.apply(need_restore=False):
        pass
    assert torch.equal(port[0], live[0])  # the average of one step
    assert ma.minimize is None


@pytest.mark.parametrize("thres", [None, 100])
def test_exponential_moving_average(thres):
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    ref, port = _pair()
    ref_sgd = paddle.optimizer.SGD(0.1, parameters=ref)
    port_sgd = optimizer.SGD(0.1, parameters=port)
    ref_ema = paddle.optimizer.ExponentialMovingAverage(0.9,
                                                        thres_steps=thres)
    port_ema = optimizer.ExponentialMovingAverage(0.9, thres_steps=thres)
    for step in range(6):
        _sgd_steps(ref, port, ref_sgd, port_sgd, step)
        ref_ema.update(ref)
        port_ema.update(port)
        with ref_ema.apply(), port_ema.apply():
            _same(ref, port)
        _same(ref, port)


def test_ema_update_walks_the_state_registry():
    """``update()`` with no parameters tracks every live ``Parameter`` of
    ``core.state``."""
    from paddle_tpu_torch import nn, optimizer
    layer = nn.Linear(3, 2, device="cpu")
    ema = optimizer.ExponentialMovingAverage(0.5)
    ema.update()
    tracked = {id(p) for p in ema._params}
    assert {id(p) for p in layer.parameters()} <= tracked
    with ema.apply():
        assert torch.equal(layer.weight, layer.weight)


def test_lookahead_around_adam_seven_steps():
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    ref, port = _pair()
    ref_la = paddle.optimizer.LookAhead(
        paddle.optimizer.Adam(0.05, parameters=ref), alpha=0.5, k=3)
    port_la = optimizer.LookAhead(optimizer.Adam(0.05, parameters=port),
                                  alpha=0.5, k=3)
    for step in range(7):
        _grads(ref, port, step)
        ref_la.step()
        port_la.step()
        ref_la.clear_grad()
        port_la.clear_grad()
        _same(ref, port)
        assert int(port_la._la_step) == int(ref_la._la_step._value)


def _bf16_lookahead(pkg_la, pkg_adam, params):
    opt = pkg_adam(0.05, parameters=params, multi_precision=True)
    return pkg_la(opt, alpha=0.5, k=1), opt


def test_reference_lookahead_master_undoes_the_reset():
    """The reference at bf16 with float32 masters: after a sync step the
    parameter holds the slow weights, but its master still holds the fast
    ones, and the next step's parameter is computed from the master.
    Shown by a step at learning rate 0: the parameter jumps back to the
    fast weights. The port's stays at the slow weights."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import optimizer
    ref, port = _pair("bfloat16")
    ref_la, ref_opt = _bf16_lookahead(paddle.optimizer.LookAhead,
                                      paddle.optimizer.Adam, ref)
    port_la, port_opt = _bf16_lookahead(optimizer.LookAhead,
                                        optimizer.Adam, port)
    _grads(ref, port, 0)
    ref_la.step()
    port_la.step()
    ref_after = np.asarray(ref[0]._value.astype("float32"))
    port_after = port[0].detach().float().numpy()
    ref_opt.set_lr(0.0)
    port_opt.set_lr(0.0)
    _grads(ref, port, 1)
    ref_opt.step()
    port_opt.step()
    ref_next = np.asarray(ref[0]._value.astype("float32"))
    assert not np.array_equal(ref_next, ref_after)  # the fault
    assert np.array_equal(port[0].detach().float().numpy(), port_after)


def test_reference_asp_master_brings_pruned_weights_back():
    """The reference's ASP masks the bf16 parameter only; its master keeps
    the pruned values, and the next step restores them. The port masks the
    master too."""
    import paddle_tpu as paddle
    from paddle_tpu.sparsity import decorate as ref_decorate
    from paddle_tpu.sparsity import prune_model as ref_prune
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.sparsity import check_mask_1d, decorate, prune_model

    ref = paddle.nn.Linear(8, 8)
    ref.to(dtype="bfloat16")
    ref_opt = paddle.optimizer.Adam(0.0, parameters=ref.parameters(),
                                    multi_precision=True)
    ref_prune(ref)
    ref_decorate(ref_opt)
    port = nn.Linear(8, 8, device="cpu").to(torch.bfloat16)
    port_opt = optimizer.Adam(0.0, parameters=port.parameters(),
                              multi_precision=True)
    prune_model(port)
    decorate(port_opt)
    import jax.numpy as jnp
    ref.weight._grad = jnp.ones((8, 8), jnp.bfloat16)
    ref.bias._grad = jnp.ones((8,), jnp.bfloat16)
    port.weight.grad = torch.ones(8, 8, dtype=torch.bfloat16)
    port.bias.grad = torch.ones(8, dtype=torch.bfloat16)
    ref_opt.step()
    port_opt.step()
    # the decorated step masks the parameter after the update; the masters
    # differ: the reference's still holds the pruned values
    ref_master = np.asarray(
        ref_opt._accumulators[("master", id(ref.weight))]._value)
    assert not check_mask_1d(ref_master, 2, 4)
    port_master = port_opt._accumulators[("master", id(port.weight))]
    assert check_mask_1d(port_master, 2, 4)
    assert check_mask_1d(port.weight, 2, 4)
