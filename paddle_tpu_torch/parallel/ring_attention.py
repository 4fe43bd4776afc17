"""Sequence parallelism over an sp group (counterpart:
``paddle_tpu/parallel/ring_attention.py``).

Layout ``[batch, seq_local, heads, head_dim]``, the sequence split over the
group's ranks in rank order.

``ring_attention``: K and V rotate one rank a step around the group
(point-to-point, ``pipeline.ring_shift``) while this rank's queries combine
each block online (the flash-attention update, in float32); ``causal``
masks by global positions. ``ulysses_attention``: an all-to-all turns the
sequence split into a head split (``heads % n == 0``), attention runs over
the whole sequence on this rank's heads (``attention_fn``, default the
written-out float32 softmax), and a second all-to-all turns it back. Both
are differentiable: the rotations and the all-to-alls run backwards in the
backward pass. The block update is plain torch, as the reference's is
plain jnp.
"""
import functools

import torch

from ..distributed import collective
from ..distributed.fleet.meta_parallel.mp_layers import group_rank_size
from .pipeline import ring_shift

_NEG = -1e30


def _online_block(q, k, v, m, l, acc, mask=None):
    """One online-softmax block update. q: [B, H, Sq, D], k/v: [B, H, Sk,
    D], float32."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if mask is not None:
        logits = torch.where(mask, logits, _NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(logits - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                 float("-inf")))
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, acc_new


def ring_attention(q, k, v, group=None, causal=False, scale=None):
    """Attention of this rank's queries over the whole (sp-split)
    sequence."""
    my, n = group_rank_size(group)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qt = q.transpose(1, 2).float() * scale
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    m = torch.full((b, h, s_q), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s_q), device=q.device)
    acc = torch.zeros((b, h, s_q, d), device=q.device)
    q_pos = my * s_q + torch.arange(s_q, device=q.device)
    for r in range(n):
        # after r rotations this rank holds the block of rank my - r
        src = (my - r) % n
        mask = None
        if causal:
            k_pos = src * s_k + torch.arange(s_k, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        m, l, acc = _online_block(qt, kt.float(), vt.float(), m, l, acc, mask)
        if r < n - 1:
            kt, vt = ring_shift(kt, group, 1), ring_shift(vt, group, 1)
    out = acc / l[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


class _AllToAll(torch.autograd.Function):
    """Split ``x`` on ``split_dim`` over the group's ranks and concatenate
    what arrives on ``concat_dim`` (rank order)."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.group, concat_dim, split_dim), None, None, \
            None


def _all_to_all(x, group, split_dim, concat_dim):
    _, n = group_rank_size(group)
    parts = [p.contiguous() for p in x.chunk(n, dim=split_dim)]
    out = [torch.empty_like(p) for p in parts]
    if group is None:
        out = [p.clone() for p in parts]
    else:
        collective.all_to_all(out, parts, group=group)
    return torch.cat(out, dim=concat_dim)


def all_to_all(x, group, split_dim, concat_dim):
    """Differentiable all-to-all over ``group``."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def ulysses_attention(q, k, v, group=None, causal=False, scale=None,
                      attention_fn=None):
    """DeepSpeed-Ulysses sequence parallelism (see the module
    docstring)."""
    _, n = group_rank_size(group)
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} not divisible by sp={n}")

    def seq_to_heads(x):  # [B, S/n, H, D] -> [B, S, H/n, D]
        return all_to_all(x, group, 2, 1)

    qf, kf, vf = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if attention_fn is None:
        attention_fn = functools.partial(_full_attention, causal=causal,
                                         scale=scale)
    return all_to_all(attention_fn(qf, kf, vf), group, 1, 2)


def _full_attention(q, k, v, causal=False, scale=None):
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qt = q.transpose(1, 2).float() * scale
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
    if causal:
        mask = torch.ones(logits.shape[-2:], dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(vt.dtype), vt)
    return out.transpose(1, 2).to(q.dtype)
