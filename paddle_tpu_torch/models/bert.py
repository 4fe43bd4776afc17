"""BERT/ERNIE-style encoder for MLM + NSP pretraining (counterpart:
``paddle_tpu/models/bert.py``), the flagship step of the JAX package's
``bench.py``.

``BertConfig``, ``bert_base``, ``bert_large``, ``BertEmbeddings``,
``BertSelfAttention``, ``BertLayer``, ``BertModel``,
``BertPretrainingHeads``, ``BertForPretraining`` (with ``loss`` and
``flops_per_token``) and ``synthetic_mlm_batch``, with the reference's
parameter names and layouts, so a reference ``state_dict`` loads by plain
copy (``bridge``). The MLM decoder is tied to the word embeddings.

Attention runs through ``F.scaled_dot_product_attention``. BERT's
positions stop at 512 and the flash gate opens at 1024, so BERT takes the
written-out branch and runs no hand-written kernel, as in the reference.

``use_mp=True`` builds the tensor-parallel layers that the reference's
sharding annotations imply, at the degree of the fleet topology's mp group
(``models/gpt.py`` has the same): the word embeddings vocabulary-parallel
(and with them the tied decoder's logits and its bias), ``qkv`` (whole
heads) and ``fc1`` column-parallel, ``out`` and ``fc2`` row-parallel; the
MLM loss is the parallel cross entropy.
"""
import numpy as np

from .. import nn
from ..ops import plain as ops
from ..core.device import resolve_device
from ..core.tensor import boundary
from ..nn import functional as F


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_dropout=0.1, attention_dropout=0.1, use_mp=False,
                 hidden_act="gelu_tanh"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.use_mp = use_mp
        self.hidden_act = hidden_act


def _act_fn(cfg):
    act = getattr(cfg, "hidden_act", "gelu_tanh")
    if act in ("gelu_tanh", "gelu_new", "gelu_approx"):
        return lambda v: F.gelu(v, approximate=True)
    if act == "gelu":
        return F.gelu
    if act == "relu":
        return F.relu
    raise ValueError(f"unknown hidden_act {act!r}")


def _mp():
    from ..distributed.fleet.meta_parallel import mp_layers
    return mp_layers


def _mp_degree():
    mp = _mp()
    return mp.group_rank_size(mp.model_parallel_group())[1]


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096, **kw)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__()
        h = cfg.hidden_size
        if cfg.use_mp:
            self.word_embeddings = _mp().VocabParallelEmbedding(
                cfg.vocab_size, h, device=device)
        else:
            self.word_embeddings = nn.Embedding(cfg.vocab_size, h,
                                                device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  device=device)
        self.layer_norm = nn.LayerNorm(h, device=device)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None):
        seq_len = input_ids.shape[1]
        pos_ids = ops.arange(seq_len, dtype="int32", device=input_ids.device)
        emb = self.word_embeddings(input_ids)
        emb = emb + self.position_embeddings(pos_ids)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertSelfAttention(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        h = cfg.hidden_size
        if cfg.use_mp:
            mp = _mp()
            self.qkv = mp.ColumnParallelLinear(h, 3 * h, gather_output=False,
                                               device=device, split_groups=3)
            self.out = mp.RowParallelLinear(h, h, input_is_parallel=True,
                                            device=device)
            self.num_heads = cfg.num_heads // _mp_degree()
        else:
            self.qkv = nn.Linear(h, 3 * h, device=device)
            self.out = nn.Linear(h, h, device=device)
        self.dropout_p = cfg.attention_dropout

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        qkv = ops.reshape(self.qkv(x),
                          [b, s, 3, self.num_heads, self.head_dim])
        q, k, v = ops.unstack(qkv, axis=2)
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout_p,
            training=self.training)
        ctx = ops.reshape(ctx, [b, s, self.num_heads * self.head_dim])
        return self.out(ctx)


class BertLayer(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.attention = BertSelfAttention(cfg, device=device)
        self.norm1 = nn.LayerNorm(h, device=device)
        if cfg.use_mp:
            mp = _mp()
            self.fc1 = mp.ColumnParallelLinear(h, cfg.intermediate_size,
                                               gather_output=False,
                                               device=device)
            self.fc2 = mp.RowParallelLinear(cfg.intermediate_size, h,
                                            input_is_parallel=True,
                                            device=device)
        else:
            self.fc1 = nn.Linear(h, cfg.intermediate_size, device=device)
            self.fc2 = nn.Linear(cfg.intermediate_size, h, device=device)
        self.norm2 = nn.LayerNorm(h, device=device)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.act = _act_fn(cfg)

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.dropout(self.attention(x, attn_mask)))
        x = self.norm2(x + self.dropout(self.fc2(self.act(self.fc1(x)))))
        return x


class BertModel(nn.Layer):
    def __init__(self, cfg=None, device=None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        device = resolve_device(device)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, device=device)
        self.layers = nn.LayerList([BertLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                device=device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            x = layer(x, attention_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertPretrainingHeads(nn.Layer):
    """The MLM head (transform, LayerNorm, the decoder tied to
    ``embedding_weight`` plus ``decoder_bias``) and the NSP head."""

    def __init__(self, cfg, embedding_weight=None, device=None,
                 embedding_layer=None):
        super().__init__()
        h = cfg.hidden_size
        self.transform = nn.Linear(h, h, device=device)
        self.layer_norm = nn.LayerNorm(h, device=device)
        self._group = None
        if cfg.use_mp:
            # the decoder's logits are the word embeddings' vocabulary
            # slice, and so is its bias
            mp = _mp()
            self._group = mp.model_parallel_group()
            n = _mp_degree()
            self.decoder_bias = mp._mark(self.create_parameter(
                [cfg.vocab_size // n], is_bias=True, device=device), 0,
                self._group)
        else:
            self.decoder_bias = self.create_parameter(
                [cfg.vocab_size], is_bias=True, device=device)
        # the tie is held, not registered: a registered parameter would add
        # a ``cls._tied`` entry to the state_dict, which the reference lacks.
        # Given the embedding layer, it is read through that layer at each
        # call, so a forward with the layer's parameter swapped
        # (torch.func.functional_call, as jit.save's export runs it) reads
        # the swapped one.
        self.__dict__["_tied_weight"] = embedding_weight
        self.__dict__["_tied_layer"] = embedding_layer
        self.seq_relationship = nn.Linear(h, 2, device=device)
        self.act = _act_fn(cfg)

    @property
    def _tied(self):
        layer = self.__dict__["_tied_layer"]
        return self.__dict__["_tied_weight"] if layer is None \
            else layer.weight

    def forward(self, sequence_output, pooled_output):
        x = self.layer_norm(self.act(self.transform(sequence_output)))
        if self._group is not None:
            x = _mp().copy_to_region(x, self._group)
        logits = ops.matmul(x, self._tied, transpose_y=True)
        # the bias joins in the logits' dtype: a float32 bias would promote
        # the [B, S, vocab] logits to float32 under AMP
        logits = logits + ops.cast(self.decoder_bias, logits.dtype)
        nsp = self.seq_relationship(pooled_output)
        return logits, nsp


class BertForPretraining(nn.Layer):
    """MLM + NSP (the ERNIE-1.0/BERT pretraining objective)."""

    def __init__(self, cfg=None, device=None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.config = cfg
        self.bert = BertModel(cfg, device=device)
        words = self.bert.embeddings.word_embeddings
        self.cls = BertPretrainingHeads(cfg, device=words.weight.device,
                                        embedding_layer=words)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.cls(seq, pooled)

    @boundary
    def loss(self, prediction_logits, nsp_logits, masked_labels, nsp_labels,
             ignore_index=-100):
        if self.config.use_mp:
            labels = masked_labels.reshape(-1)
            per = _mp().parallel_cross_entropy(
                prediction_logits.reshape(-1, prediction_logits.shape[-1]),
                labels, self.cls._group, ignore_index)
            mlm = per.sum() / (labels != ignore_index).sum().clamp_min(1)
        else:
            mlm = F.cross_entropy(prediction_logits, masked_labels,
                                  ignore_index=ignore_index)
        nsp = F.cross_entropy(nsp_logits, nsp_labels)
        return mlm + nsp

    def flops_per_token(self, seq_len=None):
        """Training FLOPs a token, 6 N (N the unique parameters) plus the
        attention's 12 L h s (for MFU accounting)."""
        cfg = self.config
        n = _mp_degree() if cfg.use_mp else 1
        n_params = sum(p.numel() * (n if _mp().is_sliced(p)
                                    else 1) for p in self.parameters())
        s = seq_len or cfg.max_position_embeddings
        return 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * s


def synthetic_mlm_batch(batch_size, seq_len, vocab_size=30522, seed=0):
    """Deterministic synthetic pretraining batch (numpy): token ids, token
    types (zeros), MLM labels (15% of positions, else -100) and NSP
    labels."""
    rng = np.random.RandomState(seed)
    input_ids = rng.randint(0, vocab_size, (batch_size, seq_len)).astype("int32")
    token_type = np.zeros((batch_size, seq_len), dtype="int32")
    labels = np.where(rng.rand(batch_size, seq_len) < 0.15,
                      input_ids, -100).astype("int32")
    nsp = rng.randint(0, 2, (batch_size,)).astype("int32")
    return input_ids, token_type, labels, nsp
