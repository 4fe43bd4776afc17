"""``distribution`` against the reference: ``Uniform``, ``Normal`` and
``Categorical`` densities, probabilities, entropies and KL terms on the
same seeded parameters and values, batched and broadcast, with the
gradients that reach ``Tensor`` parameters; the draws (threefry against
Philox never match) by their moments, their support and a seed repeating
them, on an explicit generator.

Tolerances: densities, entropies, KL terms and gradients within 2e-6
relative to their largest element plus 1e-6 absolute (float32 rounding:
the same expressions in the same order); draws: sample means and
standard deviations of 200,000 draws within 0.01 (about 5 standard
errors) of the distribution's, category frequencies within 0.005.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distribution as RD
import paddle_tpu_torch as pt
import paddle_tpu_torch.distribution as TD

TOL, ABS = 2e-6, 1e-6
N_DRAWS, MOMENT_TOL, FREQ_TOL = 200_000, 0.01, 0.005


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import device
    saved = device._current
    torch.set_num_threads(2)
    device.set_device("cpu")
    yield
    device._current = saved


def _np(t):
    return np.asarray(t.numpy())


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    scale = max(float(np.abs(want[finite]).max()) if finite.any() else 0.0,
                1e-30)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=TOL * scale + ABS, err_msg=what)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=what)


RNG = np.random.RandomState(0)
LOC = RNG.randn(3, 1).astype(np.float32)
SCALE = (RNG.rand(3, 1) + 0.5).astype(np.float32)
VALUE = RNG.randn(3, 4).astype(np.float32) * 2
LOW = RNG.randn(4).astype(np.float32)
HIGH = (LOW + RNG.rand(4) + 0.1).astype(np.float32)
LOGITS = RNG.randn(5, 6).astype(np.float32)
LOGITS2 = RNG.randn(5, 6).astype(np.float32)
IDS = RNG.randint(0, 6, 5).astype(np.int64)


def _pair(cls_name, *arrays):
    return (getattr(RD, cls_name)(*[paddle.to_tensor(a) for a in arrays]),
            getattr(TD, cls_name)(*[torch.from_numpy(a) for a in arrays]))


@pytest.mark.parametrize("method", ["log_prob", "probs"])
def test_normal_densities(method):
    r, t = _pair("Normal", LOC, SCALE)
    _close(getattr(t, method)(torch.from_numpy(VALUE)),
           getattr(r, method)(paddle.to_tensor(VALUE)), method)


def test_normal_entropy_and_kl():
    r, t = _pair("Normal", LOC, SCALE)
    r2, t2 = _pair("Normal", LOC[::-1].copy() + 0.3, SCALE * 1.7)
    _close(t.entropy(), r.entropy(), "entropy")
    _close(t.kl_divergence(t2), r.kl_divergence(r2), "kl")


@pytest.mark.parametrize("method", ["log_prob", "probs"])
def test_uniform_densities(method):
    r, t = _pair("Uniform", LOW, HIGH)
    v = np.stack([LOW - 0.1, LOW, (LOW + HIGH) / 2, HIGH]).astype(np.float32)
    _close(getattr(t, method)(torch.from_numpy(v)),
           getattr(r, method)(paddle.to_tensor(v)), method)
    _close(t.entropy(), r.entropy(), "entropy")


@pytest.mark.parametrize("method", ["log_prob", "probs"])
def test_categorical_probabilities(method):
    r, t = _pair("Categorical", LOGITS)
    _close(getattr(t, method)(torch.from_numpy(IDS)),
           getattr(r, method)(paddle.to_tensor(IDS)), method)
    r1, t1 = _pair("Categorical", LOGITS[0])
    ids = IDS.reshape(5, 1)
    _close(getattr(t1, method)(torch.from_numpy(ids)),
           getattr(r1, method)(paddle.to_tensor(ids)), f"1-D {method}")


def test_categorical_entropy_and_kl():
    r, t = _pair("Categorical", LOGITS)
    r2, t2 = _pair("Categorical", LOGITS2)
    _close(t.entropy(), r.entropy(), "entropy")
    _close(t.kl_divergence(t2), r.kl_divergence(r2), "kl")


def test_gradients_reach_tensor_parameters():
    mu_r = paddle.to_tensor(LOC, stop_gradient=False)
    sig_r = paddle.to_tensor(SCALE, stop_gradient=False)
    RD.Normal(mu_r, sig_r).log_prob(paddle.to_tensor(VALUE)).sum().backward()
    mu_t = pt.to_tensor(LOC, place="cpu", stop_gradient=False)
    sig_t = pt.to_tensor(SCALE, place="cpu", stop_gradient=False)
    TD.Normal(mu_t, sig_t).log_prob(torch.from_numpy(VALUE)).sum().backward()
    _close(mu_t.grad, mu_r.grad, "d loc")
    _close(sig_t.grad, sig_r.grad, "d scale")
    lg_r = paddle.to_tensor(LOGITS, stop_gradient=False)
    RD.Categorical(lg_r).entropy().sum().backward()
    lg_t = pt.to_tensor(LOGITS, place="cpu", stop_gradient=False)
    TD.Categorical(lg_t).entropy().sum().backward()
    _close(lg_t.grad, lg_r.grad, "d logits")


def test_draw_moments_and_seeds():
    t = TD.Normal(1.5, 0.5)
    z = t.sample([N_DRAWS], seed=3)
    assert tuple(z.shape) == (N_DRAWS,) and z.device.type == "cpu"
    assert abs(float(z.mean()) - 1.5) < MOMENT_TOL
    assert abs(float(z.std()) - 0.5) < MOMENT_TOL
    assert torch.equal(z, t.sample([N_DRAWS], seed=3))
    assert not torch.equal(z, t.sample([N_DRAWS], seed=4))
    r = RD.Normal(1.5, 0.5).sample([N_DRAWS], seed=3)
    assert abs(float(np.asarray(r.numpy()).mean()) - float(z.mean())) \
        < 2 * MOMENT_TOL

    u = TD.Uniform(-1.0, 3.0).sample([N_DRAWS, 1], seed=5)
    assert tuple(u.shape) == (N_DRAWS, 1)
    assert float(u.min()) >= -1.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 1.0) < 4 * MOMENT_TOL
    b = TD.Uniform(torch.from_numpy(LOW), torch.from_numpy(HIGH)).sample([7])
    assert tuple(b.shape) == (7, 4)
    assert bool(((b >= torch.from_numpy(LOW)) & (b < torch.from_numpy(HIGH)))
                .all())

    pt.seed(11)
    c = TD.Categorical(torch.log(torch.tensor([0.2, 0.5, 0.3]))).sample(
        [N_DRAWS])
    assert c.dtype == torch.int64
    freq = np.bincount(c.numpy(), minlength=3) / N_DRAWS
    np.testing.assert_allclose(freq, [0.2, 0.5, 0.3], atol=FREQ_TOL)
    cb = TD.Categorical(torch.from_numpy(LOGITS)).sample([3])
    assert tuple(cb.shape) == (3, 5)


def test_scalars_live_on_the_requested_device():
    d = TD.Normal(0.0, 1.0, device="cpu")
    assert d.loc.device.type == "cpu" and d.loc.dtype == torch.float32
    assert isinstance(d.loc, pt.Tensor)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from paddle_tpu_torch.core import device
            device._current = None
            TD.Normal(0.0, 1.0)
