"""The training slice on the CPU: a tiny GPT (vocab 256, hidden 64, 2
layers, 4 heads, seq 1024, so the port's attention takes the flash branch
and its autograd Function) with the reference's weights moved over by the
bridge.

- float32: the loss and every parameter's gradient against the
  reference's (relative 1e-5: the same float32 math in another order; the
  reference on the CPU writes attention out with -1e9 masking, the port
  runs the plain flash forward and backward);
- the training recipe for 3 steps on both packages: bf16 parameters,
  ``AdamW(multi_precision=True)`` with a decay function, a global-norm
  clip, a linear warm-up and ``auto_cast`` in bf16. bf16 rounds in other
  places on the two sides (the port's attention computes in float32
  inside, the reference's CPU branch in bf16), so: losses agree to 1e-3
  relative; each step's bf16 gradients to a relative L2 of 5e-2 (one bf16
  rounding is 2^-8; measured <= 1.3e-2). The float32 masters agree to a
  root-mean-square difference of 0.25 x the summed learning rate: Adam
  moves an element by about the learning rate whatever its gradient's
  size, so an element whose gradient is near bf16 noise may step the other
  way, 2 x lr apart (measured: up to 0.08, ~0.16% of a weight's elements
  after the first step). The optimizer's own arithmetic is held tightly,
  on equal gradients, in ``test_torch_optimizer.py``. The key third of
  ``qkv.bias`` has an exactly zero gradient (a bias on k adds the same q.b
  to every score of a row, which the softmax cancels), so both sides step
  on rounding noise there; it is left out of the gradient and master
  comparisons and held only to the bound of two Adam paths apart, 2.2 x
  the summed learning rate.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu_torch import amp, nn, optimizer
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         synthetic_lm_batch)
from paddle_tpu_torch.optimizer import lr as port_lr

SEQ = 1024
HIDDEN = 64
TINY = dict(vocab_size=256, hidden_size=HIDDEN, num_layers=2, num_heads=4,
            max_seq_len=SEQ, hidden_dropout=0.0, attention_dropout=0.0)
F32_REL = 1e-5
LOSS_REL = 1e-3
GRAD_REL = 5e-2
MASTER_RMS = 0.25   # x the summed learning rate
ZERO_GRAD_MAX = 2.2  # x the summed learning rate
LR = dict(learning_rate=1e-3, warmup_steps=2, start_lr=1e-4, end_lr=1e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def pair():
    paddle.seed(5)
    ref = RefGPT(RefConfig(**TINY))
    state = {n: np.asarray(t.numpy()) for n, t in ref.state_dict().items()}
    port = load_reference_state(GPTForCausalLM(GPTConfig(**TINY),
                                               device="cpu"), state)
    return ref, port, synthetic_lm_batch(2, SEQ, TINY["vocab_size"], seed=3)


@pytest.fixture
def bwd_calls(monkeypatch):
    """Counts of the plain dQ / dK-dV kernel versions the port ran."""
    calls = {"dq": 0, "dkv": 0}
    for key, name in (("dq", "flash_attention_bwd_dq_reference"),
                      ("dkv", "flash_attention_bwd_dkv_reference")):
        def counted(*a, _real=getattr(fa, name), _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(fa, name, counted)
    return calls


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_f32_loss_and_grads_match_reference(pair, bwd_calls):
    ref, port, ids = pair
    want = ref.loss(ref(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    want.backward()
    got = port.loss(port(torch.from_numpy(ids)), torch.from_numpy(ids))
    got.backward()
    assert bwd_calls == {"dq": 2, "dkv": 2}  # one per layer
    assert abs(got.item() - float(want)) <= F32_REL * abs(float(want))
    ref_grads = {n: np.asarray(p.grad.numpy())
                 for n, p in ref.named_parameters()}
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for n, p in port.named_parameters():
        assert _rel(p.grad.numpy(), ref_grads[n]) <= F32_REL, n


def test_loss_matches_the_sliced_reference_definition(pair):
    """``loss`` masks the last position instead of slicing the logits; the
    value is the mean over ``logits[:, :-1]`` against ``labels[:, 1:]``."""
    _, port, ids = pair
    with torch.no_grad():
        logits = port(torch.from_numpy(ids))
        got = port.loss(logits, ids)
        v = logits.shape[-1]
        want = torch.nn.functional.cross_entropy(
            logits[:, :-1].reshape(-1, v),
            torch.from_numpy(ids[:, 1:]).long().reshape(-1))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    n = sum(p.numel() for p in port.parameters())
    assert port.flops_per_token(SEQ) == 6 * n + 12 * 2 * HIDDEN * SEQ


def _key_bias_split(name, x):
    """(the part compared to the reference, and the key third of qkv.bias,
    whose gradient is exactly zero, or None)."""
    if name.endswith("qkv.bias"):
        return (np.concatenate([x[:HIDDEN], x[2 * HIDDEN:]]),
                x[HIDDEN:2 * HIDDEN])
    return x, None


def test_training_recipe_matches_reference_for_three_steps(pair, bwd_calls):
    ref, port, ids = pair
    ref.to("bfloat16")
    port.to("bfloat16")
    ref_names = {p.name: n for n, p in ref.named_parameters()}

    def decays(structured):
        return not (structured.endswith(".bias") or ".ln" in structured)

    ref_sched = paddle.optimizer.lr.LinearWarmup(**LR)
    port_sched = port_lr.LinearWarmup(**LR)
    ref_opt = paddle.optimizer.AdamW(
        learning_rate=ref_sched, parameters=ref.parameters(),
        multi_precision=True, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=lambda n: decays(ref_names[n]))
    port_opt = optimizer.AdamW(
        learning_rate=port_sched, parameters=port.parameters(),
        multi_precision=True, grad_clip=nn.ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=decays)
    lr_sum = 0.0
    for step in range(3):
        lr_sum += port_opt.get_lr()
        with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
            want = ref.loss(ref(paddle.to_tensor(ids)), paddle.to_tensor(ids))
        want.backward()
        ref_grads = {ref_names[p.name]: np.asarray(
            p.grad.astype("float32").numpy()) for p in ref.parameters()}
        ref_opt.step()
        ref_opt.clear_grad()
        ref_sched.step()
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            logits = port(torch.from_numpy(ids))
            got = port.loss(logits, ids)
        assert logits.dtype == torch.bfloat16 and got.dtype == torch.float32
        got.backward()
        grads = {n: p.grad for n, p in port.named_parameters()}
        for n, g in grads.items():
            assert g.dtype == torch.bfloat16, n
            mine, _ = _key_bias_split(n, g.float().numpy())
            theirs, _ = _key_bias_split(n, ref_grads[n])
            assert _rel(mine, theirs) <= GRAD_REL, (step, n)
        port_opt.step()
        port_opt.clear_grad()
        port_sched.step()
        assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))

        ref_master = {ref_names[k.rsplit(".", 1)[0]]: np.asarray(v.numpy())
                      for k, v in ref_opt.state_dict().items()
                      if k.endswith(".master")}
        port_state = port_opt.state_dict()
        for n, p in port.named_parameters():
            master = port_state[f"{n}.master"]
            assert p.dtype == torch.bfloat16
            assert torch.equal(p.detach(), master.to(torch.bfloat16)), n
            mine, zero_grad = _key_bias_split(n, master.numpy())
            theirs, ref_zero = _key_bias_split(n, ref_master[n])
            rms = float(np.sqrt(np.mean((mine - theirs) ** 2)))
            assert rms <= MASTER_RMS * lr_sum, (step, n, rms / lr_sum)
            if zero_grad is not None:
                assert np.abs(zero_grad - ref_zero).max() <= \
                    ZERO_GRAD_MAX * lr_sum
    assert bwd_calls == {"dq": 6, "dkv": 6}


def test_step_timer_matches_reference(monkeypatch):
    """Windowed tokens/s and MFU of the port's StepTimer against the
    reference's on the same (fake) clock and counts."""
    import time

    from paddle_tpu.observability.step import StepTimer as RefTimer
    from paddle_tpu_torch.observability import StepTimer
    ticks = iter(np.cumsum([0.0] + [0.5, 0.25, 0.75, 0.5] * 2))
    clock = {}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["now"])
    kw = dict(window=3, tokens_per_step=2048, flops_per_token=1e6,
              peak_flops=1e12)
    ref, port = RefTimer(publish_as=None, **kw), StepTimer(**kw)
    for _ in range(5):
        clock["now"] = next(ticks)
        want, got = ref.step(), port.step()
        if want is None:
            assert got is None
            continue
        for key in ("steps_total", "window_steps", "step_time_ms",
                    "tokens_per_s", "mfu"):
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
