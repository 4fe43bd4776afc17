"""GPT-style decoder (counterpart: ``paddle_tpu/models/gpt.py``; GPT-3
1.3B is ``BASELINE.md``'s config 4).

``GPTConfig``, ``gpt_small``, ``gpt3_1p3b``, ``GPTBlock``, ``GPTModel`` and
``GPTForCausalLM`` (with ``loss`` and ``flops_per_token``) with the
reference's parameter names and layouts, so a reference ``state_dict``
loads by plain copy (``bridge``). The LM head is tied to ``wte``.
Attention runs through ``F.scaled_dot_product_attention(is_causal=True)``,
which takes the flash-attention kernels at ``seq_len >= 1024``.

``use_mp=True`` builds the tensor-parallel layers that the reference's
sharding annotations imply, at the degree of the fleet topology's mp group:
``wte`` vocabulary-parallel, ``qkv`` and ``fc1`` column-parallel (``qkv``
with whole heads of q, k and v on each rank), ``proj`` and ``fc2``
row-parallel; the tied head gives vocabulary-split logits and ``loss`` is
the parallel cross entropy. ``bridge.load_reference_state`` slices a
reference ``state_dict`` for each rank.

``build_pipeline_layer`` is the reference's ``PipelineLayer`` of GPT
(embedding stage, blocks, final LayerNorm with an untied head), and
``build_gpt_1f1b_step`` the fused 1F1B step over a model's own parameters
(``parallel.spmd_pipeline_1f1b``).
"""
import functools

import numpy as np
import torch

from .. import nn
from ..ops import plain as ops
from ..core.device import resolve_device
from ..core.tensor import boundary
from ..nn import functional as F


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 hidden_dropout=0.1, attention_dropout=0.1, use_mp=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        self.use_mp = use_mp


def gpt3_1p3b(**kw):
    return GPTConfig(**dict(dict(hidden_size=2048, num_layers=24,
                                 num_heads=16), **kw))


def gpt_small(**kw):
    return GPTConfig(**kw)


def _mp():
    from ..distributed.fleet.meta_parallel import mp_layers
    return mp_layers


class GPTBlock(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.use_mp = bool(getattr(cfg, "use_mp", False))
        if self.use_mp:
            mp = _mp()
            n = mp.group_rank_size(mp.model_parallel_group())[1]
            column = functools.partial(mp.ColumnParallelLinear,
                                       gather_output=False, device=device)
            row = functools.partial(mp.RowParallelLinear,
                                    input_is_parallel=True, device=device)
        else:
            n = 1
            column = row = functools.partial(nn.Linear, device=device)
        # the reference's order of registration (the parameters' order)
        self.ln1 = nn.LayerNorm(h, device=device)
        self.qkv = (column(h, 3 * h, split_groups=3) if self.use_mp
                    else column(h, 3 * h))
        self.proj = row(h, h)
        self.ln2 = nn.LayerNorm(h, device=device)
        self.fc1 = column(h, cfg.intermediate_size)
        self.fc2 = row(cfg.intermediate_size, h)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.num_heads = cfg.num_heads // n
        self.head_dim = h // cfg.num_heads
        self.attn_dropout_p = cfg.attention_dropout

    def _attention(self, q, k, v):
        def attend():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout_p,
                training=self.training)
        if self.use_mp and self.training and self.attn_dropout_p > 0:
            # each mp rank's heads draw their own masks
            from ..distributed.fleet.meta_parallel import random as mp_random
            tracker = mp_random.get_rng_state_tracker()
            if mp_random.MODEL_PARALLEL_RNG in tracker.states_:
                with tracker.rng_state():
                    return attend()
        return attend()

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        h = self.ln1(x)
        qkv = ops.reshape(self.qkv(h), [b, s, 3, self.num_heads, self.head_dim])
        q, k, v = ops.unstack(qkv, axis=2)
        ctx = self._attention(q, k, v)
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
        if getattr(cfg, "use_mp", False):
            self.wte = _mp().VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, device=device)
        else:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                    device=device)
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
        if self.config.use_mp:
            # the head's slice of the vocabulary; the hidden state's
            # gradient sums over the mp ranks
            mp = _mp()
            hidden = mp.copy_to_region(hidden, self.gpt.wte._group)
        # weight-tied LM head
        return ops.matmul(hidden, self.gpt.wte.weight, transpose_y=True)

    @boundary
    def loss(self, logits, labels):
        """Next-token cross entropy, mean over positions 0..S-2 (the
        reference's ``logits[:, :-1]`` against ``labels[:, 1:]``). The last
        position's label is set to ``ignore_index`` instead of slicing the
        logits, which would copy ``[B, S-1, vocab]``; the mean is the
        same. Under ``use_mp`` the logits are this rank's vocabulary slice
        and the cross entropy is the parallel one."""
        v = logits.shape[-1]
        labels = torch.as_tensor(labels, device=logits.device).long()
        shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                            -100)], dim=1)
        logits, shifted = ops.reshape(logits, [-1, v]), ops.reshape(shifted,
                                                                    [-1])
        if not self.config.use_mp:
            return F.cross_entropy(logits, shifted, ignore_index=-100)
        per = _mp().parallel_cross_entropy(logits, shifted,
                                           self.gpt.wte._group)
        return per.sum() / (shifted != -100).sum().clamp_min(1)

    def flops_per_token(self, seq_len=None):
        cfg = self.config
        n = sum(p.numel() for p in self.parameters())
        if cfg.use_mp:  # the whole model's count
            n = sum(p.numel() * (self.gpt.wte._mp_degree
                                 if _mp().is_sliced(p)
                                 else 1) for p in self.parameters())
        s = seq_len or cfg.max_seq_len
        return 6 * n + 12 * cfg.num_layers * cfg.hidden_size * s


def build_pipeline_layer(cfg, num_stages, loss_fn=None, device=None,
                         stage_id=None, seg_method="uniform"):
    """GPT as the reference's ``PipelineLayer``: an embedding stage (wte +
    wpe), the blocks, and a head stage (final LayerNorm and an untied
    ``Linear`` to the vocabulary, no bias), segmented into ``num_stages``;
    this rank builds its stage (``stage_id``, default its pipe
    coordinate)."""
    from ..distributed.fleet.meta_parallel import LayerDesc, PipelineLayer

    class _EmbedStage(nn.Layer):
        def __init__(self, device=None):
            super().__init__()
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                    device=device)
            self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size,
                                    device=device)

        def forward(self, input_ids):
            s = input_ids.shape[1]
            pos = ops.arange(s, dtype="int32", device=input_ids.device)
            return self.wte(input_ids) + self.wpe(pos)

    class _HeadStage(nn.Layer):
        def __init__(self, device=None):
            super().__init__()
            self.ln_f = nn.LayerNorm(cfg.hidden_size, device=device)
            self.head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False, device=device)

        def forward(self, x):
            return self.head(self.ln_f(x))

    descs = ([LayerDesc(_EmbedStage)]
             + [LayerDesc(GPTBlock, cfg) for _ in range(cfg.num_layers)]
             + [LayerDesc(_HeadStage)])
    return PipelineLayer(descs, num_stages=num_stages, loss_fn=loss_fn,
                         seg_method=seg_method, stage_id=stage_id,
                         device=resolve_device(device))


def build_gpt_1f1b_step(model, mesh=None, axis_pp="pp", axis_dp=None):
    """The fused 1F1B training step over ``model``'s own parameters
    (``parallel.spmd_pipeline_1f1b`` over the mesh's ``axis_pp`` group):
    this rank's stage runs blocks ``[s * L/S, (s + 1) * L/S)`` through the
    blocks' own forward (``torch.func.functional_call``), stage 0 the
    embedding (wte + wpe, and the model's dropout), the last stage the final
    LayerNorm, the tied head and ``model.loss``. With ``axis_dp`` dim 1 of
    the microbatches is split over that group and the loss and gradients
    are averaged over it.

    Returns ``(run, (stage_params, first_params, last_params,
    leaf_names))``: ``run(ids [M, mb, T], labels [M, mb, T]) -> (loss,
    (stage_grads, first_grads, last_grads))``, the stage's gradients as
    ``stage_params`` nests them (per block, ``leaf_names`` order), the
    others summed over the stages. The tied ``wte``'s gradient is
    ``first_grads[0] + last_grads[2]``."""
    from torch.func import functional_call

    from ..distributed import collective, parallel_env
    from ..parallel import spmd_pipeline_1f1b

    mesh = mesh if mesh is not None else parallel_env.current_mesh()
    cfg = model.config
    group = parallel_env.axis_group(mesh, axis_pp)
    pp = parallel_env.axis_degree(mesh, axis_pp)
    stage = parallel_env.axis_rank(mesh, axis_pp)
    L = cfg.num_layers
    if L % pp:
        raise ValueError(f"num_layers {L} must divide by pp {pp}")
    per = L // pp
    blocks = [model.gpt.blocks[stage * per + i] for i in range(per)]
    leaf_names = sorted(blocks[0].state_dict().keys())

    def snapshot_params():
        sd = [dict(b.named_parameters()) for b in blocks]
        stage_params = tuple(tuple(d[n] for n in leaf_names) for d in sd)
        first = (model.gpt.wte.weight, model.gpt.wpe.weight)
        last = (model.gpt.ln_f.weight, model.gpt.ln_f.bias,
                model.gpt.wte.weight)  # the tied head
        return stage_params, first, last

    def stage_fn(params, x):
        for blk, leaves in zip(blocks, params):
            x = functional_call(blk, dict(zip(leaf_names, leaves)), (x,))
        return x

    def first_fn(fp, ids):
        wte, wpe = fp
        pos = ops.arange(ids.shape[-1], dtype="int32", device=ids.device)
        return model.gpt.drop(F.embedding(ids, wte) + F.embedding(pos, wpe))

    def last_fn(lp, h, labels):
        norm = functional_call(model.gpt.ln_f, {"weight": lp[0],
                                                "bias": lp[1]}, (h,))
        return model.loss(ops.matmul(norm, lp[2], transpose_y=True), labels)

    dp_group = (parallel_env.axis_group(mesh, axis_dp)
                if axis_dp is not None else None)

    def run(ids_micro, labels_micro, params=None):
        sp, fp, lp = params if params is not None else snapshot_params()
        if dp_group is not None:
            dp = parallel_env.axis_degree(mesh, axis_dp)
            r = parallel_env.axis_rank(mesh, axis_dp)
            b = ids_micro.shape[1] // dp
            ids_micro = ids_micro[:, r * b:(r + 1) * b]
            labels_micro = labels_micro[:, r * b:(r + 1) * b]
        loss, gP, gF, gL = spmd_pipeline_1f1b(
            stage_fn, last_fn, sp, lp, ids_micro, labels_micro,
            first_fn=first_fn, first_params=fp, group=group)
        if dp_group is not None:
            for t in [loss, *gF, *gL, *(g for blk in gP for g in blk)]:
                collective.all_reduce(t, op=collective.ReduceOp.AVG,
                                      group=dp_group)
        return loss, (gP, gF, gL)

    run.snapshot_params = snapshot_params
    return run, (*snapshot_params(), leaf_names)


def synthetic_lm_batch(batch_size, seq_len, vocab_size=50304, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab_size, (batch_size, seq_len)).astype("int32")
    return ids
