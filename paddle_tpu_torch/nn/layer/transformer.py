"""The Transformer layers (counterpart:
``paddle_tpu/nn/layer/transformer.py``).

``MultiHeadAttention`` keeps the reference's projections and caches
(``Cache`` for a decoder's own keys and values, grown a step at a time;
``StaticCache`` for the encoder memory's, computed once) and computes
through ``F.scaled_dot_product_attention`` with its own ``dropout``, so
it reaches the flash kernels where the reference reaches its Pallas ones:
no mask, dropout inactive and a sequence of at least ``_FLASH_MIN_SEQ``.
``gen_cache`` makes float32 empty caches whatever the model's dtype, as
the reference does, so under bf16 ``auto_cast`` each step's ``concat`` of
a bf16 key with the cache is float32 (and the attention casts it back to
bf16, an allow-listed op). The stacks copy their first layer
(``copy.deepcopy``), so every layer starts from the same weights, as in
the reference. ``Transformer``'s defaults are Transformer-base (Vaswani et
al., 2017: d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1,
ReLU, post-norm).
"""
import collections
import copy

import torch

from ...core.device import resolve_device
from ...core.tensor import Tensor, unwrap, wrap
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

Cache = collections.namedtuple("Cache", ["k", "v"])
StaticCache = collections.namedtuple("StaticCache", ["k", "v"])


class MultiHeadAttention(Layer):
    Cache = Cache
    StaticCache = StaticCache

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             device=device)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             device=device)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             device=device)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               device=device)

    def _shape(self, x):
        """``[B, S, E] -> [B, S, H, D]``."""
        return torch.reshape(x, (x.shape[0], x.shape[1], self.num_heads,
                                 self.head_dim))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """The attended ``[B, S, E]``; with a ``Cache``, also the cache
        grown by this call's keys and values."""
        key = query if key is None else key
        value = query if value is None else value
        if cache is not None:  # a namedtuple the Layer boundary keeps
            cache = type(cache)(*unwrap(tuple(cache)))
        q = self._shape(self.q_proj(query))
        if isinstance(cache, StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
        if isinstance(cache, Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if isinstance(cache, Cache):
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=Cache):  # noqa: A002
        """A ``StaticCache`` of ``key``'s (and ``value``'s) projections,
        or an empty float32 ``Cache`` ``[B, 0, H, D]`` on ``key``'s
        device; of ``Tensor``s for a ``Tensor`` key."""
        as_key = wrap if isinstance(key, Tensor) else (lambda t: t)
        key = unwrap(key)
        if type == StaticCache:
            value = key if value is None else unwrap(value)
            return StaticCache(as_key(self._shape(self.k_proj(key))),
                               as_key(self._shape(self.v_proj(value))))
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return Cache(*(as_key(torch.zeros(shape, dtype=torch.float32,
                                          device=key.device))
                       for _ in range(2)))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)

        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


def _clones(layer, n):
    return LayerList([layer] + [copy.deepcopy(layer) for _ in range(n - 1)])


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=device)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, device=device)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, device=device)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """With ``cache`` = (``Cache``, ``StaticCache``): the output and
        (the grown ``Cache``, the ``StaticCache``)."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        static_cache = cache[1] if cache is not None else None
        if static_cache is not None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  static_cache)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=device)
            enc_norm = (LayerNorm(d_model, device=device)
                        if normalize_before else None)
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device=device)
            dec_norm = (LayerNorm(d_model, device=device)
                        if normalize_before else None)
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The ``[length, length]`` float32 additive causal mask: 0 on and
        below the diagonal, -1e9 above, as a ``Tensor`` on ``device``
        (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=dev).tril()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return wrap(torch.where(keep, zero, -1e9))
