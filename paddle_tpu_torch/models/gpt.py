"""GPT-style decoder (counterpart: ``paddle_tpu/models/gpt.py``).

``GPTConfig``, ``gpt_small``, ``GPTBlock``, ``GPTModel`` and
``GPTForCausalLM`` (with ``loss`` and ``flops_per_token``) with the
reference's parameter names and layouts, so a reference ``state_dict``
loads by plain copy (``bridge``). The LM head is tied to ``wte``.
Attention runs through ``F.scaled_dot_product_attention(is_causal=True)``,
which takes the flash-attention kernels at ``seq_len >= 1024``.
"""
import numpy as np
import torch

from .. import nn, ops
from ..core.device import resolve_device
from ..nn import functional as F


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 hidden_dropout=0.1, attention_dropout=0.1):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout


def gpt_small(**kw):
    return GPTConfig(**kw)


class GPTBlock(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.ln1 = nn.LayerNorm(h, device=device)
        self.qkv = nn.Linear(h, 3 * h, device=device)
        self.proj = nn.Linear(h, h, device=device)
        self.ln2 = nn.LayerNorm(h, device=device)
        self.fc1 = nn.Linear(h, cfg.intermediate_size, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, h, device=device)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.attn_dropout_p = cfg.attention_dropout

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        h = self.ln1(x)
        qkv = ops.reshape(self.qkv(h), [b, s, 3, self.num_heads, self.head_dim])
        q, k, v = ops.unstack(qkv, axis=2)
        ctx = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout_p,
            training=self.training)
        ctx = ops.reshape(ctx, [b, s, self.num_heads * self.head_dim])
        x = x + self.dropout(self.proj(ctx))
        h = self.ln2(x)
        x = x + self.dropout(self.fc2(F.gelu(self.fc1(h))))
        return x


class GPTModel(nn.Layer):
    def __init__(self, cfg=None, device=None, **kwargs):
        super().__init__()
        cfg = cfg or GPTConfig(**kwargs)
        device = resolve_device(device)
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                device=device)
        self.drop = nn.Dropout(cfg.hidden_dropout)
        self.blocks = nn.LayerList([GPTBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, device=device)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = ops.arange(s, dtype="int32", device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Layer):
    def __init__(self, cfg=None, device=None, **kwargs):
        super().__init__()
        cfg = cfg or GPTConfig(**kwargs)
        self.config = cfg
        self.gpt = GPTModel(cfg, device=device)

    def forward(self, input_ids):
        hidden = self.gpt(input_ids)
        # weight-tied LM head
        return ops.matmul(hidden, self.gpt.wte.weight, transpose_y=True)

    def loss(self, logits, labels):
        """Next-token cross entropy, mean over positions 0..S-2 (the
        reference's ``logits[:, :-1]`` against ``labels[:, 1:]``). The last
        position's label is set to ``ignore_index`` instead of slicing the
        logits, which would copy ``[B, S-1, vocab]``; the mean is the
        same."""
        v = logits.shape[-1]
        labels = torch.as_tensor(labels, device=logits.device).long()
        shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                            -100)], dim=1)
        return F.cross_entropy(ops.reshape(logits, [-1, v]),
                               ops.reshape(shifted, [-1]), ignore_index=-100)

    def flops_per_token(self, seq_len=None):
        cfg = self.config
        n = sum(p.numel() for p in self.parameters())
        s = seq_len or cfg.max_seq_len
        return 6 * n + 12 * cfg.num_layers * cfg.hidden_size * s


def synthetic_lm_batch(batch_size, seq_len, vocab_size=50304, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab_size, (batch_size, seq_len)).astype("int32")
    return ids
