"""The attention gate consults the kernels' limits (a repaired fault: it
used to send every mask-free call at seq >= 1024 to kernels that raise
outside their limits). ``kernels.flash_attention.supports`` is true only
for what the CUDA kernels take; where it is false the gate writes the
attention out, as the reference does when its kernel is unavailable
(``paddle_tpu/nn/functional/attention.py:27-33``). On the CPU.

The written-out result is held against the reference's
``scaled_dot_product_attention`` (which writes attention out on the CPU)
on the same inputs: float32 to 1e-5 relative L2 (the same math in another
order), bf16 and float16 to 1e-2 (one rounding of the output is 2^-8).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as ref_F
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention

SEQ = 1024
REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture
def no_kernel(monkeypatch):
    """Fail if the gate reaches the kernels' Function."""
    def refuse(*a, **k):
        raise AssertionError("the gate took the flash branch")
    monkeypatch.setattr(fa, "flash_attention_bshd", refuse)


def _qkv(shape, dtype, seed=0):
    x = np.random.RandomState(seed).randn(3, *shape).astype("float32")
    return [torch.from_numpy(a).to(dtype) for a in x]


def _misaligned_bf16():
    """q/k/v as views whose seq stride (68 elements, 136 bytes) is not a
    multiple of 16 bytes: the TMA loads cannot take them."""
    base = _qkv((1, SEQ, 68), torch.bfloat16)
    return [b.as_strided((1, SEQ, 2, 32), (SEQ * 68, 68, 32, 1))
            for b in base]


LIMITS = {
    "float16": lambda: _qkv((1, SEQ, 2, 64), torch.float16),
    "head dim 96": lambda: _qkv((1, SEQ, 2, 96), torch.float32),
    "misaligned bf16 strides": _misaligned_bf16,
}


@pytest.mark.parametrize("limit", sorted(LIMITS))
def test_gate_writes_out_what_the_kernels_do_not_take(limit, no_kernel):
    q, k, v = LIMITS[limit]()
    assert not fa.supports(q, k, v)
    assert not attention.takes_flash(q, k, v)
    got = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert got.shape == q.shape and got.dtype == q.dtype
    t = [paddle.to_tensor(x.float().contiguous().numpy()) for x in (q, k, v)]
    want = ref_F.scaled_dot_product_attention(*t, is_causal=True).numpy()
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= REL[q.dtype], rel


def test_batch_times_heads_over_the_grid_limit():
    """B*H = 65536 > 65535: the kernels' grid cannot hold it. The inputs
    are stride-0 views (no memory), so only the gate's decision runs."""
    q = torch.zeros(1, SEQ, 1, 64).expand(32768, SEQ, 2, 64)
    assert q.shape[0] * q.shape[2] == fa._MAX_GRID_Y + 1
    assert not fa.supports(q, q, q)
    assert not attention.takes_flash(q, q, q)
    small = torch.zeros(1, SEQ, 1, 64).expand(32767, SEQ, 2, 64)
    assert fa.supports(small, small, small)


@pytest.mark.parametrize("dtype, d", [(torch.float32, 32),
                                      (torch.bfloat16, 64),
                                      (torch.float32, 128)])
def test_gate_takes_the_kernels_inside_their_limits(dtype, d, monkeypatch):
    calls = []
    real = fa.flash_attention_bshd
    monkeypatch.setattr(fa, "flash_attention_bshd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    # the model's layout: strided views of one fused QKV tensor
    qkv = _qkv((1, SEQ, 3, 2, d), dtype)[0].unbind(2)
    assert fa.supports(*qkv)
    out = F.scaled_dot_product_attention(*qkv, is_causal=True)
    assert calls == [1] and out.shape == qkv[0].shape


def test_gate_keeps_the_reference_conditions():
    q, k, v = _qkv((1, SEQ, 2, 64), torch.float32)
    assert attention.takes_flash(q, k, v)
    assert not attention.takes_flash(q, k, v, attn_mask=torch.ones(SEQ, SEQ))
    assert not attention.takes_flash(q, k, v, dropout_p=0.1)
    assert attention.takes_flash(q, k, v, dropout_p=0.1, training=False)
    short = [x[:, :SEQ - 1] for x in (q, k, v)]
    assert fa.supports(*short) and not attention.takes_flash(*short)
    assert not fa.supports(q, k.to(torch.bfloat16), v)  # mixed dtypes
    assert not fa.supports(q[..., ::2], k[..., ::2], v[..., ::2])  # D strided
