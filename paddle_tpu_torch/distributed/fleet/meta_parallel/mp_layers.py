"""Tensor-parallel layers (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``).

Megatron-style: each mp rank holds its slice of a weight, and autograd
Functions move activations across the mp group:

- copy-to-region: identity forward, all-reduce of the gradient backward
  (a replicated activation entering a sharded product);
- reduce-from-region: all-reduce forward, identity backward (the partial
  sums of a sharded product; the result is replicated);
- gather-from-region / scatter-to-region: the last dim gathered from (or
  split over) the ranks, and the reverse for the gradient.

``ColumnParallelLinear`` holds ``weight[:, cols]`` and ``bias[cols]``;
``RowParallelLinear`` holds ``weight[rows, :]`` and the whole bias, added
once after the reduction; ``VocabParallelEmbedding`` holds a range of
vocabulary rows (ids outside it look up zeros before the all-reduce);
``ParallelCrossEntropy`` takes logits whose class dim is split over the
ranks: the max and the sum of exponentials are all-reduced, and the
target's logit comes from the rank that holds it. Every sliced parameter
carries ``split_axis`` (the dim it is split
on), ``split_rank`` and ``split_degree``; ``split_groups = g`` says that dim
is ``g`` blocks each split over the ranks (a fused QKV: whole heads of q, k
and v on every rank). ``bridge`` slices the reference's full arrays by them
and gathers them back.

The group is ``mp_group`` (a ``collective.Group`` or process group) or the
fleet topology's model-parallel group. At one rank every collective still
runs (a one-rank group).
"""
import torch

from ....nn import functional as F
from ....nn import initializer as I
from ....nn.layer.layers import Layer
from ....amp.auto_cast import cast_inputs
from ... import collective
from ..base.topology import get_hybrid_communicate_group


def model_parallel_group(mp_group=None):
    """``mp_group``, else the fleet topology's model-parallel group (None
    without one: a world of one rank)."""
    if mp_group is not None:
        return mp_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def group_rank_size(group):
    if group is None:
        return 0, 1
    if isinstance(group, collective.Group):
        return group.rank, group.nranks
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def _all_reduce(x, group, op=collective.ReduceOp.SUM):
    if group is not None:
        collective.all_reduce(x, op=op, group=group)
    return x


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, n = group_rank_size(group)
        ctx.group, ctx.rank, ctx.n = group, rank, n
        parts = []
        collective.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.rank].contiguous(), None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, n = group_rank_size(group)
        ctx.group, ctx.n = group, n
        return x.chunk(n, dim=-1)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = []
        collective.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=-1), None


def copy_to_region(x, group):
    return _CopyToRegion.apply(x, group)


def reduce_from_region(x, group):
    return _ReduceFromRegion.apply(x, group)


def gather_from_region(x, group):
    return _GatherFromRegion.apply(x, group)


def scatter_to_region(x, group):
    return _ScatterToRegion.apply(x, group)


def is_sliced(p):
    """Whether ``p`` is one rank's slice of a tensor-parallel parameter."""
    return getattr(p, "split_axis", None) is not None


def _mark(p, axis, group, split_groups=1):
    """Tag ``p`` as this rank's slice of dim ``axis`` (of ``split_groups``
    blocks each split over ``group``)."""
    p.split_axis = axis
    p.split_groups = split_groups
    p.split_rank, p.split_degree = group_rank_size(group)
    return p


def _slice_size(full, n, what):
    if full % n:
        raise ValueError(f"{what} {full} does not divide over {n} mp ranks")
    return full // n


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None, mp_group=None, device=None):
        super().__init__()
        self._group = model_parallel_group(mp_group)
        rank, n = group_rank_size(self._group)
        self._mp_degree = n
        per = _slice_size(num_embeddings, n, "vocabulary")
        self.vocab_start, self.vocab_end = rank * per, (rank + 1) * per
        self.weight = _mark(self.create_parameter(
            [per, embedding_dim], device=device,
            default_initializer=I.Normal(0.0, 1.0)), 0, self._group)

    def forward(self, x):
        outside = (x < self.vocab_start) | (x >= self.vocab_end)
        local = torch.where(outside, 0, x - self.vocab_start)
        out = F.embedding(local, self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return reduce_from_region(out, self._group)


class ColumnParallelLinear(Layer):
    """``y = x @ W[:, cols] + b[cols]``; ``gather_output`` concatenates the
    ranks' columns. ``split_groups`` > 1 splits each of that many column
    blocks over the ranks (a fused QKV keeps whole heads of each)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, split_groups=1):
        super().__init__()
        self._group = model_parallel_group(mp_group)
        self.gather_output = gather_output
        _, n = group_rank_size(self._group)
        per = _slice_size(out_features, n * split_groups, "out_features")
        local = per * split_groups
        self.weight = _mark(self.create_parameter(
            [in_features, local], device=device,
            default_initializer=I.XavierNormal(in_features, out_features)),
            1, self._group, split_groups)
        self.bias = _mark(self.create_parameter(
            [local], is_bias=True, device=device), 0, self._group,
            split_groups) if has_bias else None

    def forward(self, x):
        y = F.linear(copy_to_region(x, self._group), self.weight, self.bias)
        return gather_from_region(y, self._group) if self.gather_output \
            else y


class RowParallelLinear(Layer):
    """``y = sum over ranks of x[..., rows] @ W[rows, :]``, then the whole
    bias, once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None):
        super().__init__()
        self._group = model_parallel_group(mp_group)
        self.input_is_parallel = input_is_parallel
        _, n = group_rank_size(self._group)
        per = _slice_size(in_features, n, "in_features")
        self.weight = _mark(self.create_parameter(
            [per, out_features], device=device,
            default_initializer=I.XavierNormal(in_features, out_features)),
            0, self._group)
        self.bias = self.create_parameter(
            [out_features], is_bias=True, device=device) if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_region(x, self._group)
        x, w, b = cast_inputs("linear", x, self.weight, self.bias)
        y = reduce_from_region(torch.matmul(x, w), self._group)
        return y if b is None else y + b


def parallel_cross_entropy(logits, label, group, ignore_index=-100):
    """Per-row softmax cross entropy of class-split ``logits`` ``[N,
    V/n]`` against global ``label`` ``[N]``: 0 where the label is
    ``ignore_index``. The log-sum-exp accumulates in float32, as
    ``F.cross_entropy`` does."""
    (logits,) = cast_inputs("cross_entropy", logits)
    rank, _ = group_rank_size(group)
    v_local = logits.shape[-1]
    m = _all_reduce(logits.detach().amax(dim=-1, keepdim=True), group,
                    collective.ReduceOp.MAX)
    se = reduce_from_region(
        torch.exp(logits - m).sum(dim=-1, dtype=torch.float32), group)
    lse = m.squeeze(-1).float() + torch.log(se)
    idx = label.long()
    valid = idx != ignore_index
    local = idx - rank * v_local
    mine = valid & (local >= 0) & (local < v_local)
    picked = logits.gather(-1, torch.where(mine, local, 0).unsqueeze(-1))
    picked = reduce_from_region(
        torch.where(mine, picked.squeeze(-1).float(), 0.0), group)
    return torch.where(valid, lse - picked, 0.0)


class ParallelCrossEntropy(Layer):
    """Cross entropy over logits whose class dim is split over the mp
    group; returns the per-row loss ``[..., 1]`` (the reference's
    shape)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._group = model_parallel_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        v = input.shape[-1]
        loss = parallel_cross_entropy(input.reshape(-1, v),
                                      label.reshape(-1), self._group,
                                      self.ignore_index)
        return loss.reshape(*label.shape[:input.dim() - 1], 1)
