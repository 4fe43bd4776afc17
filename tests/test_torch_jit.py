"""The k-step program on the CPU: ``jit.to_static(one_step, scan_steps=k)``
of the port against k eager calls of the same body (bitwise: on the CPU the
program is a plain loop) and against the reference's scan-compiled
program, on ``bench.py``'s BERT step (AMP in bf16, AdamW at its lr 1e-4) at
``test_torch_bert.py``'s small size; the stacked-input contract, the
per-step outputs, the errors, gradients that live across steps and the
RNG advancing per inner step. The card's path (CUDA graphs) is driven by
``chip_smoke.py``.

Against the reference's scan: the per-step losses to
``tests/test_scan_step.py``'s rtol 2e-3 (measured 2.5e-3 on the second
step at ten times bench's rate, 1e-3, where that test runs: one step's
updates differ more there, see below); the parameters as
``test_torch_bert.py`` holds three eager steps, a root-mean-square
difference of 0.5 x the summed rate per tensor and 2.2 x on the key third
of each ``qkv.bias`` (an element with a gradient near bf16 noise may step
the other way, 2 x lr apart; ``test_scan_step.py``'s parameter bound
compares one package with itself, where no such element exists).
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch.models import bert

from test_torch_bert import (BATCH, BENCH_LR, MASTER_RMS, SEQ, TINY,
                             ZERO_GRAD_MAX, _key_bias_split, _pair,
                             bench_step)

SCAN_RTOL = 2e-3
K = 2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _stacked_batches(k):
    """k different microbatches stacked [k, ...] (numpy)."""
    per_step = [bert.synthetic_mlm_batch(BATCH, SEQ, TINY["vocab_size"],
                                         seed=20 + i) for i in range(k)]
    return [np.stack(col) for col in zip(*per_step)]


def _port_bench(port):
    opt = optimizer.AdamW(parameters=port.parameters(),
                          learning_rate=BENCH_LR)
    return opt, bench_step(paddle_tpu_torch, port, opt)


def test_kstep_program_is_k_eager_steps_bitwise():
    _, port = _pair()
    twin = copy.deepcopy(port)
    opt_e, eager_step = _port_bench(port)
    opt_s, body = _port_bench(twin)
    stacked = [torch.from_numpy(a) for a in _stacked_batches(3)]
    want = torch.stack([eager_step(*(a[i] for a in stacked))
                        for i in range(3)])
    got = jit.to_static(body, scan_steps=3)(*stacked)
    assert got.shape == (3,) and torch.equal(got.detach(), want.detach())
    for (n, p), q in zip(port.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n
        assert q.grad is None, n  # cleared inside the body
    for key, v in opt_e.state_dict().items():
        w = opt_s.state_dict()[key]
        assert torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w
    assert int(opt_s.state_dict()["@step"]) == 3


def test_kstep_program_matches_reference_scan():
    ref, port = _pair()
    ref_opt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                     learning_rate=BENCH_LR)
    ref_names = {p.name: n for n, p in ref.named_parameters()}
    stacked = _stacked_batches(K)
    want = paddle.jit.to_static(bench_step(paddle, ref, ref_opt),
                                scan_steps=K)(
        *(paddle.to_tensor(a) for a in stacked)).numpy()
    _, body = _port_bench(port)
    got = jit.to_static(body, scan_steps=K)(
        *(torch.from_numpy(a) for a in stacked))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=SCAN_RTOL)
    ref_vals = {ref_names[p.name]: np.asarray(p.numpy())
                for p in ref.parameters()}
    lr_sum = BENCH_LR * K
    for n, p in port.named_parameters():
        mine, zero = _key_bias_split(n, p.detach().numpy())
        theirs, ref_zero = _key_bias_split(n, ref_vals[n])
        rms = float(np.sqrt(np.mean((mine - theirs) ** 2)))
        assert rms <= MASTER_RMS * lr_sum, (n, rms / lr_sum)
        if zero is not None:
            assert np.abs(zero - ref_zero).max() <= ZERO_GRAD_MAX * lr_sum


def test_unrolled_program_runs_the_function_once_a_call():
    """``to_static(k_steps)``, ``bench.py``'s default structure: the
    program is the function, k eager steps inside."""
    _, port = _pair()
    twin = copy.deepcopy(port)
    _, eager_step = _port_bench(port)
    _, body = _port_bench(twin)
    batch = [torch.from_numpy(a) for a in bert.synthetic_mlm_batch(
        BATCH, SEQ, TINY["vocab_size"], seed=3)]

    @jit.to_static
    def k_steps(*args):
        for _ in range(2):
            loss = body(*args)
        return loss

    for _ in range(2):
        eager_step(*batch)
        want = eager_step(*batch)
        assert torch.equal(k_steps(*batch), want)


def test_outputs_come_back_stacked():
    paddle_tpu_torch.seed(0)
    m = nn.Linear(4, 3, device="cpu")

    def body(x, scale, offset=None):
        y = m(x) * scale
        return {"y": y, "pair": (y.sum(), None), "offset": offset + 1}

    step = jit.to_static(body, scan_steps=5)
    out = step(torch.randn(5, 2, 4), 2.0, offset=torch.zeros(5, 7))
    assert out["y"].shape == (5, 2, 3)
    assert out["pair"][0].shape == (5,) and out["pair"][1] is None
    assert out["offset"].shape == (5, 7)


def test_contract_errors():
    with pytest.raises(ValueError, match="scan_steps"):
        jit.to_static(lambda x: x, scan_steps=0)
    # dp_axis and accumulate_steps are options of the scan step program,
    # with the reference's errors (tests/test_zero_sharding.py)
    for kw in (dict(dp_axis="dp"), dict(accumulate_steps=2)):
        with pytest.raises(ValueError, match="scan step"):
            jit.to_static(lambda x: x, **kw)
    with pytest.raises(ValueError, match="multiple of"):
        jit.to_static(lambda x: x, scan_steps=3, accumulate_steps=2)
    m = nn.Linear(4, 2, device="cpu")
    step = jit.to_static(lambda x: m(x).mean(), scan_steps=3)
    with pytest.raises(ValueError, match=r"stacked \[k, \.\.\.\]"):
        step(torch.rand(8, 4))
    with pytest.raises(ValueError, match="tensor argument"):
        jit.to_static(lambda s: s, scan_steps=3)(1.0)
    with pytest.raises(TypeError, match="outputs"):
        jit.to_static(lambda x: 1.0, scan_steps=3)(torch.rand(3, 2))


def test_grads_left_live_accumulate_across_inner_steps():
    """A gradient the body does not clear carries across the inner steps
    and across calls (the reference's persistable gradients)."""
    xs = torch.from_numpy(np.random.RandomState(11).rand(4, 5, 3)
                          .astype("float32"))
    paddle_tpu_torch.seed(1)
    m1 = nn.Linear(3, 2, device="cpu")
    for i in range(4):
        m1(xs[i]).mean().backward()
    paddle_tpu_torch.seed(1)
    m2 = nn.Linear(3, 2, device="cpu")

    def one(xb):
        loss = m2(xb).mean()
        loss.backward()
        return loss

    step = jit.to_static(one, scan_steps=4)
    step(xs)
    torch.testing.assert_close(m2.weight.grad, m1.weight.grad, rtol=1e-5,
                               atol=0)
    step(xs)
    torch.testing.assert_close(m2.weight.grad, 2 * m1.weight.grad,
                               rtol=1e-5, atol=0)


def test_rng_advances_per_inner_step():
    paddle_tpu_torch.seed(3)
    drop = nn.Dropout(0.5)
    d = jit.to_static(lambda xb: drop(xb), scan_steps=4)
    outs = d(torch.ones(4, 2, 16))
    masks = {tuple((outs[i] != 0).flatten().tolist()) for i in range(4)}
    assert len(masks) > 1, "dropout masks identical across inner steps"
