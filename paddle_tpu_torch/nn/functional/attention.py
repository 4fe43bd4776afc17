"""scaled_dot_product_attention (counterpart:
``paddle_tpu/nn/functional/attention.py``).

Same gate and branch conditions as the reference: with no mask, dropout
inactive and ``seq_len >= _FLASH_MIN_SEQ`` the call goes to the
flash-attention kernels (``kernels.flash_attention``: the CUDA kernels on
the card, their plain versions on the CPU); otherwise the attention is
written out in torch ops, with the reference's ``-1e9`` masking and
max-subtracted softmax.
"""
import torch

from ...amp.auto_cast import cast_inputs
from ...core.random import default_generator
from ...kernels import flash_attention as _fa

# The reference's TPU-measured crossover, kept so both packages take the
# same branches; the H100 crossover is measured separately.
_FLASH_MIN_SEQ = 1024


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, training=True,
                                 scale=None):
    """q/k/v: [batch, seq, heads, head_dim] (paddle layout). The flash
    branch is differentiable through the kernels' autograd Function."""
    query, key, value, attn_mask = cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    seq_len = query.shape[1]
    dropout_inactive = dropout_p == 0.0 or not training
    if dropout_inactive and attn_mask is None and seq_len >= _FLASH_MIN_SEQ:
        return _fa.flash_attention_bshd(query, key, value, causal=is_causal,
                                        scale=scale)

    d = query.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qt = query.transpose(1, 2)  # [B, H, S, D]
    kt = key.transpose(1, 2)
    vt = value.transpose(1, 2)
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * s
    neg = torch.tensor(-1e9, dtype=logits.dtype, device=logits.device)
    if is_causal:
        causal = torch.ones(logits.shape[-2], logits.shape[-1], dtype=torch.bool,
                            device=logits.device).tril()
        logits = torch.where(causal, logits, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, neg)
        else:
            logits = logits + attn_mask
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0 and training:
        u = torch.rand(probs.shape, generator=default_generator(probs.device),
                       device=probs.device)
        probs = torch.where(u >= dropout_p, probs / (1.0 - dropout_p), 0.0)
    out = torch.matmul(probs.to(vt.dtype), vt)
    return out.transpose(1, 2)  # back to [B, S, H, D]
