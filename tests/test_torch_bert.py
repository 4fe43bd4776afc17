"""BERT pretraining on the CPU: the port's ``models.bert`` against the
reference's with the same weights (moved by ``bridge``) and the same
batches (numpy, from a seed), at 2 layers, hidden 64, 4 heads,
intermediate 128, vocab 512, seq 64, batch 2 (``tests/test_scan_step.py``'s
small BERT). Attention at seq 64 takes the written-out branch on both
sides.

Tolerances:

- float32 logits and NSP logits: relative L2 1e-5, the loss 1e-5 relative
  (the same float32 math in another order; measured <= 1.2e-6), every
  gradient relative L2 1e-4 (measured <= 2.8e-5, on the 2-vector
  ``cls.seq_relationship.bias``, a sum over the batch);
- the bf16 AMP loss: 5e-3 relative (bf16 rounds in other places on the two
  sides; measured 3.6e-4);
- three steps of ``bench.py``'s ``one_step`` (AMP in bf16, AdamW at lr
  1e-4): losses 5e-3 relative (measured <= 1.3e-3). Parameters (or the
  float32 masters of bf16 parameters) to a root-mean-square difference of
  0.5 x the summed learning rate per tensor: Adam moves an element by
  about the rate whatever its gradient's size, so an element whose
  gradient is near bf16 noise may step the other way, 2 x lr apart; 0.5
  allows one such element in 16 of a tensor (measured: 0.25, one element of
  a 64-wide LayerNorm weight). The key third of each ``qkv.bias`` has an
  exactly zero gradient (a bias on k adds the same q.b to every score of a
  row, which the softmax cancels), so both sides step on rounding noise
  there; it is held only to two Adam paths apart, 2.2 x the summed rate
  (measured 1.99).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as ref_bert
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.models import bert

SEQ, BATCH, HIDDEN = 64, 2, 64
TINY = dict(vocab_size=512, hidden_size=HIDDEN, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=SEQ,
            hidden_dropout=0.0, attention_dropout=0.0)
F32_REL = 1e-5
F32_GRAD_REL = 1e-4
AMP_LOSS_REL = 5e-3
STEP_LOSS_REL = 5e-3
MASTER_RMS = 0.5     # x the summed learning rate
ZERO_GRAD_MAX = 2.2  # x the summed learning rate
BENCH_LR = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pair(**extra):
    paddle.seed(0)
    ref = ref_bert.BertForPretraining(ref_bert.BertConfig(**TINY, **extra))
    state = {n: np.asarray(t.numpy()) for n, t in ref.state_dict().items()}
    port = load_reference_state(bert.BertForPretraining(
        bert.BertConfig(**TINY, **extra), device="cpu"), state)
    return ref, port


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(seed=1):
    return bert.synthetic_mlm_batch(BATCH, SEQ, TINY["vocab_size"], seed=seed)


def _names_and_shapes(model, as_shape):
    return {n: tuple(as_shape(t)) for n, t in model.state_dict().items()}


def test_state_dict_matches_reference_and_ties_the_decoder():
    ref, port = _pair()
    want = _names_and_shapes(ref, lambda t: t.shape)
    got = _names_and_shapes(port, lambda t: t.shape)
    assert got == want and len(got) == 38
    assert "cls._tied" not in got and "cls.decoder_bias" in got
    params = list(port.parameters())
    assert len(params) == 38  # the tied weight once
    assert port.cls._tied is port.bert.embeddings.word_embeddings.weight


def test_bert_base_state_dict_matches_reference():
    paddle.seed(0)
    want = _names_and_shapes(ref_bert.BertForPretraining(ref_bert.bert_base()),
                             lambda t: t.shape)
    port = bert.BertForPretraining(bert.bert_base(), device="cpu")
    assert _names_and_shapes(port, lambda t: t.shape) == want
    assert len(want) == 158 and len(list(port.parameters())) == 158


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "relu"])
def test_f32_forward_loss_and_grads_match_reference(act, mask):
    ref, port = _pair(hidden_act=act)
    ids, tok, labels, nsp = _batch()
    m = None
    if mask is not None:
        keep = np.ones((BATCH, 1, 1, SEQ), bool)
        keep[1, ..., SEQ - 14:] = False  # the second row is padded
        m = keep if mask == "bool" else np.where(keep, 0.0, -1e4).astype(
            "float32")
    r = [paddle.to_tensor(x) for x in (ids, tok, labels, nsp)]
    r_logits, r_nsp = ref(r[0], r[1], None if m is None else
                          paddle.to_tensor(m))
    want = ref.loss(r_logits, r_nsp, r[2], r[3])
    want.backward()
    t = [torch.from_numpy(x) for x in (ids, tok, labels, nsp)]
    logits, nsp_logits = port(t[0], t[1], None if m is None else
                              torch.from_numpy(m))
    got = port.loss(logits, nsp_logits, t[2], t[3])
    got.backward()
    assert _rel(logits.detach().numpy(), r_logits.numpy()) <= F32_REL
    assert _rel(nsp_logits.detach().numpy(), r_nsp.numpy()) <= F32_REL
    assert abs(got.item() - float(want)) <= F32_REL * abs(float(want))
    ref_grads = {n: np.asarray(p.grad.numpy())
                 for n, p in ref.named_parameters() if p.grad is not None}
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()
             if p.grad is not None}
    assert sorted(grads) == sorted(ref_grads)
    for n, g in grads.items():
        assert _rel(g, ref_grads[n]) <= F32_GRAD_REL, n


def test_amp_loss_matches_reference():
    ref, port = _pair()
    ids, tok, labels, nsp = _batch()
    r = [paddle.to_tensor(x) for x in (ids, tok, labels, nsp)]
    with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
        want = ref.loss(*ref(r[0], r[1]), r[2], r[3])
    t = [torch.from_numpy(x) for x in (ids, tok, labels, nsp)]
    with amp.auto_cast(enable=True, dtype="bfloat16"):
        logits, nsp_logits = port(t[0], t[1])
        got = port.loss(logits, nsp_logits, t[2], t[3])
    # the [B, S, vocab] logits stay in bf16 (the bias joins in their dtype)
    assert logits.dtype == torch.bfloat16 and got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= AMP_LOSS_REL * abs(float(want))


def test_flops_per_token_and_synthetic_batch_match_reference():
    ref, port = _pair()
    assert port.flops_per_token(SEQ) == ref.flops_per_token(SEQ)
    assert port.flops_per_token() == ref.flops_per_token()
    for a, b in zip(bert.synthetic_mlm_batch(3, 32, 100, seed=7),
                    ref_bert.synthetic_mlm_batch(3, 32, 100, seed=7)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_unported_options_raise():
    # use_mp is ported (tests/test_torch_hybrid.py); an unknown activation
    # still raises
    with pytest.raises(ValueError, match="hidden_act"):
        bert.BertForPretraining(bert.BertConfig(**TINY, hidden_act="swish"),
                                device="cpu")


def _key_bias_split(name, x):
    """(the part compared elementwise, and the key third of a qkv.bias,
    whose gradient is exactly zero, or None)."""
    if name.endswith("qkv.bias"):
        return (np.concatenate([x[:HIDDEN], x[2 * HIDDEN:]]),
                x[HIDDEN:2 * HIDDEN])
    return x, None


def bench_step(paddle_mod, model, opt):
    """``bench.py``'s ``one_step`` for either package (without the
    reference's XLA scheduling barrier, which changes no value)."""
    def one_step(ids, tok, labels, nsp_labels):
        with paddle_mod.amp.auto_cast(enable=True, dtype="bfloat16"):
            logits, nsp = model(ids, tok)
            loss = model.loss(logits, nsp, labels, nsp_labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return one_step


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_bench_one_step_matches_reference_for_three_steps(bf16):
    import paddle_tpu_torch
    ref, port = _pair()
    if bf16:
        ref.to("bfloat16")
        port.to("bfloat16")
    ref_names = {p.name: n for n, p in ref.named_parameters()}
    ref_opt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                     learning_rate=BENCH_LR,
                                     multi_precision=bf16)
    port_opt = optimizer.AdamW(parameters=port.parameters(),
                               learning_rate=BENCH_LR, multi_precision=bf16)
    ref_step = bench_step(paddle, ref, ref_opt)
    port_step = bench_step(paddle_tpu_torch, port, port_opt)
    for step in range(3):
        batch = _batch(seed=10 + step)
        want = ref_step(*(paddle.to_tensor(x) for x in batch))
        got = port_step(*(torch.from_numpy(x) for x in batch))
        assert abs(got.item() - float(want)) <= STEP_LOSS_REL * abs(
            float(want)), step
        lr_sum = BENCH_LR * (step + 1)
        if bf16:
            want_vals = {ref_names[k.rsplit(".", 1)[0]]: np.asarray(v.numpy())
                         for k, v in ref_opt.state_dict().items()
                         if k.endswith(".master")}
            state = port_opt.state_dict()
            got_vals = {n: state[f"{n}.master"].numpy()
                        for n, _ in port.named_parameters()}
            for n, p in port.named_parameters():
                assert p.dtype == torch.bfloat16
                assert torch.equal(p.detach(),
                                   state[f"{n}.master"].to(torch.bfloat16))
        else:
            want_vals = {n: np.asarray(p.numpy())
                         for n, p in ref.named_parameters()}
            got_vals = {n: p.detach().numpy()
                        for n, p in port.named_parameters()}
        assert sorted(got_vals) == sorted(want_vals)
        for n, mine in got_vals.items():
            mine, zero = _key_bias_split(n, mine)
            theirs, ref_zero = _key_bias_split(n, want_vals[n])
            rms = float(np.sqrt(np.mean((mine - theirs) ** 2)))
            assert rms <= MASTER_RMS * lr_sum, (step, n, rms / lr_sum)
            if zero is not None:
                assert np.abs(zero - ref_zero).max() <= ZERO_GRAD_MAX * lr_sum
