"""Pipeline parallelism as one step over the pipe group (counterpart:
``paddle_tpu/parallel/pipeline.py``).

The reference compiles the whole schedule into one XLA program over a
``pp`` mesh axis (``shard_map``, ``ppermute``). Here each pp rank calls the
same function with its own stage's parameters and the pipe group, and
activations move by point-to-point messages between neighbouring ranks.

``spmd_pipeline_1f1b`` keeps the reference's windows: at step ``t`` stage
``s`` runs the forward of microbatch ``t - s`` and the backward of
microbatch ``t - (2S - 2 - s)``, each where it is in ``[0, M)``, for
``M + 2S - 2`` steps. The forward runs without autograd and keeps only its
stage input, in a ring of ``ring_buffer_size(S, M)`` slots (and what its
random ops drew); the backward recomputes the stage from that input with
autograd, reusing the forward's draws (``recompute``'s kept draws), so
dropout masks agree. Every message is posted without waiting and received
one step after it is sent, so no two stages wait on each other.

``spmd_pipeline`` is the forward GPipe schedule, differentiable: the
activations rotate one rank a step (``ring_shift``), and the last stage's
outputs are summed over the group (all-reduce forward, identity backward).
"""
import torch
import torch.utils._pytree as pytree

from ..distributed import collective
from ..distributed.fleet.meta_parallel.mp_layers import (group_rank_size,
                                                        reduce_from_region)
from ..distributed.fleet.meta_parallel.pipeline_parallel import (
    recv_activation, send_activation)
from ..recompute import _Kept, _KeepProducts, _ReuseProducts, nothing_saveable


def pipe_group(group=None):
    """``group``, else the fleet topology's pipe group (None: one stage)."""
    if group is not None:
        return group
    from ..distributed.fleet.base.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_pipe_parallel_group() if hcg is not None else None


class _RingShift(torch.autograd.Function):
    """``x`` of group rank ``r - offset`` arrives at rank ``r``; the
    gradient goes the other way."""

    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return _shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.offset), None, None


def _shift(x, group, offset):
    rank, n = group_rank_size(group)
    if n == 1 or offset % n == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    works = collective.batch_isend_irecv([
        collective.P2POp(collective.isend, x,
                         collective.peer(group, (rank + offset) % n), group),
        collective.P2POp(collective.irecv, out,
                         collective.peer(group, (rank - offset) % n), group)])
    for w in works:
        w.wait()
    return out


def ring_shift(x, group, offset=1):
    """Rotate ``x`` ``offset`` ranks forward over ``group``
    (differentiable)."""
    return _RingShift.apply(x, group, offset)


def spmd_pipeline(stage_fn, stage_params, microbatches, group=None):
    """GPipe forward over the pipe group: ``stage_fn(stage_params, x)`` is
    this rank's stage (shape-preserving); ``microbatches`` ``[M, ...]`` is
    replicated. Returns the last stage's ``[M, ...]`` outputs on every
    rank."""
    group = pipe_group(group)
    stage, n = group_rank_size(group)
    n_micro = microbatches.shape[0]
    recv = torch.zeros_like(microbatches[0])
    outputs = []
    for t in range(n_micro + n - 1):
        inject = microbatches[min(t, n_micro - 1)]
        x = inject if stage == 0 else recv
        y = stage_fn(stage_params, x)
        out_t = t - (n - 1)
        if out_t >= 0:
            outputs.append(y if stage == n - 1 else torch.zeros_like(y))
        recv = ring_shift(y, group, 1)
    out = torch.stack(outputs)
    return reduce_from_region(out, group) if group is not None else out


def ring_buffer_size(n_stages, n_micro):
    """Slots of saved stage inputs under 1F1B: stage s holds at most
    2(S - s) - 1 microbatches in flight, so min(M, 2S - 1) slots bound every
    stage."""
    return min(n_micro, 2 * n_stages - 1)


def spmd_pipeline_1f1b(stage_fn, last_fn, stage_params, last_params,
                       microbatches, labels, first_fn=None, first_params=None,
                       group=None):
    """One 1F1B forward and backward over the pipe group (see the module
    docstring). ``stage_fn(stage_params, hidden) -> hidden`` is this rank's
    stage; ``first_fn(first_params, raw) -> hidden`` runs on stage 0 (the
    identity if None); ``last_fn(last_params, hidden, label) -> loss`` on
    the last stage. Parameters are pytrees of tensors; ``microbatches`` and
    ``labels`` are ``[M, ...]``, the same on every rank.

    Returns ``(mean_loss, stage_grads, first_grads, last_grads)``: the loss
    on every rank, this stage's gradients of the mean, and the first and
    last stages' gradients summed over the group (every rank has them)."""
    group = pipe_group(group)
    stage, S = group_rank_size(group)
    M = microbatches.shape[0]
    B = ring_buffer_size(S, M)
    T = M + 2 * S - 2
    is_first, is_last = stage == 0, stage == S - 1
    if first_fn is None:
        def first_fn(_, x):
            return x
    sp, sp_spec = pytree.tree_flatten(stage_params)
    fp, fp_spec = pytree.tree_flatten(first_params)
    lp, lp_spec = pytree.tree_flatten(last_params)
    device = microbatches.device
    gP = [torch.zeros_like(p) for p in sp]
    gF = [torch.zeros_like(p) for p in fp]
    gL = [torch.zeros_like(p) for p in lp]
    loss_buf = torch.zeros(M, dtype=torch.float32, device=device)
    slots = [None] * B  # (stage input, kept draws) of a microbatch in flight
    sends = []

    def run(s_leaves, f_leaves, l_leaves, x, m):
        """The stage's forward of microbatch m (and the loss on the last
        stage)."""
        if is_first:
            x = first_fn(pytree.tree_unflatten(f_leaves, fp_spec),
                         microbatches[m])
        y = stage_fn(pytree.tree_unflatten(s_leaves, sp_spec), x)
        if is_last:
            return x, y, last_fn(pytree.tree_unflatten(l_leaves, lp_spec), y,
                                 labels[m]).float()
        return x, y, None

    for t in range(T):
        mf = t - stage
        if 0 <= mf < M:
            x_in = None if is_first else recv_activation(stage - 1, group,
                                                         device)
            kept = _Kept()
            with torch.no_grad(), _KeepProducts(nothing_saveable, kept,
                                                False):
                _, y, loss = run(sp, fp, lp, x_in, mf)
            slots[mf % B] = (x_in, kept)
            if is_last:
                loss_buf[mf] = loss
            else:
                send_activation(y, stage + 1, group, sends)
        mb = t - (2 * S - 2 - stage)
        if 0 <= mb < M:
            x_in, kept = slots[mb % B]
            slots[mb % B] = None
            req = [p.detach().requires_grad_() for p in sp]
            f_req = [p.detach().requires_grad_() for p in fp] \
                if is_first else list(fp)
            l_req = [p.detach().requires_grad_() for p in lp] \
                if is_last else list(lp)
            x = None if is_first else x_in.detach().requires_grad_()
            with torch.enable_grad(), kept, _ReuseProducts(nothing_saveable,
                                                           kept):
                _, y, loss = run(req, f_req, l_req, x, mb)
            inputs = req + (f_req if is_first else []) + (
                l_req if is_last else []) + ([] if is_first else [x])
            if is_last:
                grads = torch.autograd.grad(loss, inputs, allow_unused=True)
            else:
                cot = torch.empty_like(y)
                collective.recv(cot, collective.peer(group, stage + 1), group)
                grads = torch.autograd.grad(y, inputs, grad_outputs=cot,
                                            allow_unused=True)
            grads = list(grads)
            for acc in (gP, gF if is_first else [], gL if is_last else []):
                for i, a in enumerate(acc):
                    g = grads.pop(0)
                    if g is not None:
                        acc[i] = a + g.to(a.dtype)
            if not is_first:
                dx = grads.pop(0)
                dx = (torch.zeros_like(x) if dx is None else dx).contiguous()
                sends.append((collective.isend(
                    dx, collective.peer(group, stage - 1), group), dx))
    for work, _ in sends:
        work.wait()
    total = loss_buf.sum() * float(is_last)
    if group is not None:
        collective.all_reduce(total, group=group)
    inv = 1.0 / M
    gP = [g * inv for g in gP]
    gF = [g * inv for g in gF]
    gL = [g * inv for g in gL]
    if group is not None:
        for g in gF + gL:
            collective.all_reduce(g, group=group)
    return (total / M, pytree.tree_unflatten(gP, sp_spec),
            pytree.tree_unflatten(gF, fp_spec),
            pytree.tree_unflatten(gL, lp_spec))


def pipelined_transformer_step(block_fn, embed_fn, head_loss_fn):
    """A pipelined training loss of a uniform transformer: the embedding
    on every rank, the blocks through :func:`spmd_pipeline`, the head and
    loss on every rank. Returns ``loss_fn(stage_block_params,
    other_params, micro_ids, micro_labels, group=None)``."""

    def loss_fn(stage_block_params, other_params, micro_ids, micro_labels,
                group=None):
        emb = torch.stack([embed_fn(other_params, ids) for ids in micro_ids])
        outs = spmd_pipeline(block_fn, stage_block_params, emb, group=group)
        return torch.stack([head_loss_fn(other_params, h, y)
                            for h, y in zip(outs, micro_labels)]).mean()

    return loss_fn
