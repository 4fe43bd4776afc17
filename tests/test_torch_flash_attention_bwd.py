"""The port's flash-attention gradients (``paddle_tpu_torch.kernels.
flash_attention.FlashAttention``) against ``jax.grad`` of the reference
Pallas kernels run in interpret mode, on the cases of
``tests/test_kernels.py`` plus the model's fused-QKV strided layout.

On the CPU the Function's backward runs the plain PyTorch versions of the
dQ and dK/dV kernels (the CUDA kernels are held against those on the card
by ``chip_smoke.py``); each test checks ``grad_fn`` so that the Function's
own backward, not autograd through the plain forward, is what runs. Inputs
and the output gradient are made with numpy from a seed.

Tolerances: float32 1e-4 (as the reference's own gradient test: the same
f32 algorithm, 64- vs 128-row tiles); bf16 2e-2 (each side rounds f32
gradients of size O(1) to bf16 once, 2^-8 relative, and the f32 sums
before it differ in order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import \
    flash_attention_bshd as ref_flash
from paddle_tpu_torch.kernels import flash_attention as fa

F32_TOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _arrays(seed, b, s_q, h, d, s_k=None):
    rng = np.random.RandomState(seed)
    s_k = s_k or s_q
    shapes = [(b, s_q, h, d), (b, s_k, h, d), (b, s_k, h, d), (b, s_q, h, d)]
    return [rng.randn(*s).astype("float32") for s in shapes]


def _ref_grads(q, k, v, do, causal, dtype=jnp.float32):
    def loss(q, k, v):
        out = ref_flash(q, k, v, causal=causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, do, causal):
    """(dq, dk, dv) as float32 numpy, the output, and the input dtype."""
    out = fa.flash_attention_bshd(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, (q, k, v), do.to(out.dtype))
    for g, x in zip(grads, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    return [g.float().numpy() for g in grads]


def _leaf(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype).requires_grad_()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 384, 200])
def test_grads_match_pallas_interpret(s, causal):
    q, k, v, do = _arrays(s + causal, 2, s, 2, 64)
    want = _ref_grads(q, k, v, do, causal)
    got = _port_grads(_leaf(q), _leaf(k), _leaf(v), torch.from_numpy(do),
                      causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_bf16_grads_match_pallas_interpret():
    q, k, v, do = _arrays(7, 1, 256, 2, 64)
    want = _ref_grads(q, k, v, do, True, dtype=jnp.bfloat16)
    got = _port_grads(*(_leaf(x, torch.bfloat16) for x in (q, k, v)),
                      torch.from_numpy(do), True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=BF16_TOL, atol=BF16_TOL)


def test_cross_attention_grads():
    q, k, v, do = _arrays(9, 1, 128, 2, 32, s_k=320)
    want = _ref_grads(q, k, v, do, False)
    got = _port_grads(_leaf(q), _leaf(k), _leaf(v), torch.from_numpy(do),
                      False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_fused_qkv_strided_layout():
    """q/k/v as the model cuts them: strided views of one [B, S, 3, H, D]
    projection; the gradient flows back into the fused tensor."""
    rng = np.random.RandomState(13)
    qkv = rng.randn(2, 256, 3, 2, 64).astype("float32")
    do = rng.randn(2, 256, 2, 64).astype("float32")
    want = _ref_grads(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do, True)
    fused = torch.from_numpy(qkv).requires_grad_()
    q, k, v = fused.unbind(2)
    assert q.stride(3) == 1 and not q.is_contiguous()
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(fused.grad.numpy(), np.stack(want, axis=2),
                               rtol=F32_TOL, atol=F32_TOL)


def test_function_backward_runs_the_plain_kernels(monkeypatch):
    """On the CPU the Function's backward takes the plain dQ and dK/dV
    versions, once each, with delta = rowsum(O * dO)."""
    calls = []
    names = ("flash_attention_bwd_dq_reference",
             "flash_attention_bwd_dkv_reference")
    for name in names:
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name:
                            calls.append((_n, a[5])) or _r(*a))
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(3, 1, 128, 2, 32))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    out.backward(do)
    assert [n for n, _ in calls] == list(names)
    want_delta = (out.detach() * do).sum(-1).permute(0, 2, 1)
    for _, delta in calls:
        torch.testing.assert_close(delta, want_delta, rtol=1e-6, atol=1e-6)


def test_no_grad_and_inference_mode_take_the_forward_only():
    q, k, v, _ = (torch.from_numpy(x) for x in _arrays(5, 1, 64, 2, 32))
    with torch.inference_mode():
        out = fa.flash_attention_bshd(q, k, v, causal=True)
    assert out.shape == q.shape and out.grad_fn is None
    with torch.no_grad():
        out = fa.flash_attention_bshd(q.requires_grad_(), k, v, causal=True)
    assert out.grad_fn is None


def test_bwd_wrappers_check_their_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(2, 1, 64, 2, 32))
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_attention_bwd_dq(q, k, v, do[:, :32], lse, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dkv(q, k, v, do, lse[:, :1], lse)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, lse.double())
