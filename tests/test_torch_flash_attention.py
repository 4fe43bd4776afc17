"""The port's flash-attention forward (``paddle_tpu_torch.kernels.
flash_attention``) against the reference Pallas kernel run in interpret
mode, on the cases of ``tests/test_kernels.py``.

On the CPU the port's wrapper takes its plain PyTorch version (the CUDA
kernel itself is checked against that version on the card by
``chip_smoke.py``). Inputs are made with numpy from a seed and fed to
both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import \
    flash_attention_bshd as ref_flash
from paddle_tpu_torch.kernels import flash_attention as fa

F32_TOL = 1e-5   # as tests/test_kernels.py: same f32 algorithm, other order
BF16_TOL = 1e-2  # one bf16 rounding step of O (2^-8 relative) and then some


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _qkv(seed, b, s_q, h, d, s_k=None):
    rng = np.random.RandomState(seed)
    s_k = s_k or s_q
    return (rng.randn(b, s_q, h, d).astype("float32"),
            rng.randn(b, s_k, h, d).astype("float32"),
            rng.randn(b, s_k, h, d).astype("float32"))


def _both(q, k, v, causal, dtype=None):
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if dtype == "bfloat16":
        jq, jk, jv = (x.astype(jnp.bfloat16) for x in (jq, jk, jv))
        tq, tk, tv = (x.to(torch.bfloat16) for x in (tq, tk, tv))
    want = ref_flash(jq, jk, jv, causal=causal, interpret=True)
    got = fa.flash_attention_bshd(tq, tk, tv, causal=causal)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy(), got


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 384, 200])
def test_forward_matches_pallas_interpret(s, causal):
    want, got, _ = _both(*_qkv(s, 2, s, 2, 64), causal)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_bf16_input_matches_pallas_interpret():
    want, got, raw = _both(*_qkv(7, 1, 256, 2, 64), True, dtype="bfloat16")
    assert raw.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


def test_cross_attention_lengths():
    want, got, _ = _both(*_qkv(9, 1, 128, 2, 32, s_k=320), False)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_is_the_row_logsumexp(causal):
    q, k, v = _qkv(11, 1, 200, 2, 32)
    _, lse = fa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(32)
    if causal:
        logits = np.where(np.tril(np.ones((200, 200), bool)), logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (1, 2, 200) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_causal_needs_equal_lengths():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 128, 2, 32, s_k=256))
    with pytest.raises(NotImplementedError, match="s_q == s_k"):
        fa.flash_attention_bshd(q, k, v, causal=True)


def test_no_silent_cpu_run():
    """Without CUDA, entry points whose device is left unset raise; the
    wrapper takes its plain version only for CPU tensors."""
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig(vocab_size=16, hidden_size=8, num_layers=1,
                                 num_heads=2, max_seq_len=8))
    meta = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(meta, meta, meta)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_variant_follows_the_dtype(d):
    """bf16 takes the tensor-core kernels; float32 the CUDA-core ones,
    which keep f32 products (the tensor cores would round them to TF32)."""
    assert fa._variant(torch.bfloat16, d) == "tensor_core"
    assert fa._variant(torch.float32, d) == "cuda_core"


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_library_follows_the_variant(d):
    """Each wrapper's library by dtype: bf16 the sm90 tensor-core sources,
    float32 the CUDA-core ones."""
    want = {"flash_attention_fwd": ("flash_attention_fwd_sm90",
                                    "flash_attention_fwd"),
            "flash_attention_bwd_dq": ("flash_attention_bwd_dq_sm90",
                                       "flash_attention_bwd"),
            "flash_attention_bwd_dkv": ("flash_attention_bwd_dkv_sm90",
                                        "flash_attention_bwd")}
    for wrapper, (bf16, f32) in want.items():
        for dtype, library in ((torch.bfloat16, bf16), (torch.float32, f32)):
            assert fa.KERNELS[wrapper, fa._variant(dtype, d)][0] == library


def test_every_kernel_entry_is_in_its_source():
    """Each (library, entry point) of the table names a source under csrc
    that defines that entry point with as many pointers and strides as
    the wrapper passes."""
    from paddle_tpu_torch.kernels import _build
    for library, entry, n_ptr, n_strides in fa.KERNELS.values():
        src = (_build.CSRC / f"{library}.cu").read_text()
        head = src[src.index(f"int {entry}("):]
        params = head[:head.index(")")]
        assert params.count("void*") == n_ptr + 1  # + the stream
        assert params.count("long long") == n_strides


@pytest.mark.parametrize("dtype, d, error", [
    (torch.float16, 64, TypeError), (torch.float64, 64, TypeError),
    (torch.bfloat16, 96, ValueError), (torch.float32, 96, ValueError)])
def test_variant_raises_on_what_no_kernel_takes(dtype, d, error):
    with pytest.raises(error):
        fa._variant(dtype, d)


def test_tensor_core_inputs_need_tma_alignment():
    """The bf16 kernels load through TMA: a base address or a batch, seq or
    head stride off 16 bytes raises; the float32 kernels take them."""
    flat = torch.zeros(1 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
    ok = flat[:1024].view(1, 8, 2, 64)
    assert fa._check_cuda({"q": ok}, 1, 2, 64, torch.bfloat16) == \
        "tensor_core"
    shifted = flat[1:1025].view(1, 8, 2, 64)  # base 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned base"):
        fa._check_cuda({"q": shifted}, 1, 2, 64, torch.bfloat16)
    wide = torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa._check_cuda({"k": wide}, 1, 2, 64, torch.bfloat16)
    assert fa._check_cuda({"k": wide.float()[..., :64]}, 1, 2, 64,
                          torch.float32) == "cuda_core"
    fused = torch.zeros(2, 16, 3, 2, 64, dtype=torch.bfloat16)
    q, k, v = fused.unbind(2)  # the model's layout passes
    assert fa._check_cuda({"q": q, "k": k, "v": v}, 2, 2, 64,
                          torch.bfloat16) == "tensor_core"
    # the dK/dV kernel also loads dO through TMA
    flat_do = torch.zeros(2 * 16 * 2 * 64 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dO needs a 16-byte aligned"):
        fa._check_cuda({"q": q, "k": k, "v": v,
                        "dO": flat_do[4:4100].view(2, 16, 2, 64)},
                       2, 2, 64, torch.bfloat16)


def test_launch_counts_reset_per_variant():
    fa.reset_launch_counts()
    for wrapper in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                    fa.flash_attention_bwd_dkv):
        assert wrapper.launches == 0
        assert wrapper.variant_launches == {"bf16": 0, "float32": 0}
