"""Mixture of experts with expert parallelism over an ep group
(counterpart: ``paddle_tpu/parallel/moe.py``).

Switch routing (top-1) with a static capacity per expert: tokens beyond
an expert's capacity are dropped (zero output; the caller's residual
carries them). With ``group`` each rank holds ``E_local`` of the ``E =
E_local * ep`` experts and the tokens move by one all-to-all each way
(``ring_attention.all_to_all``, differentiable). The Switch load-balance
loss is computed from routing statistics averaged over the group first,
so every rank optimizes the group's balance; the average's backward
averages the gradients too (the reference's ``pmean``).
"""
import torch

from ..distributed import collective
from ..distributed.fleet.meta_parallel.mp_layers import group_rank_size
from ..nn import functional as F
from .ring_attention import all_to_all


def switch_route(x, gate_w, num_experts, capacity):
    """Top-1 routing of ``x`` ``[T, D]`` by ``gate_w`` ``[D, E]``: (expert
    ``[T]``, slot ``[T]`` (-1 where dropped), the chosen expert's gate
    probability ``[T]``, every probability ``[T, E]``)."""
    probs = torch.softmax((x @ gate_w).float(), dim=-1)
    expert = probs.argmax(dim=-1)
    prob = probs.gather(1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, num_experts)
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    pos = torch.where(pos < capacity, pos, -1)
    return expert, pos, prob, probs


class _GroupMean(torch.autograd.Function):
    """All-reduce mean over ``group``, whose backward is the same mean."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.all_reduce(x.clone(), op=collective.ReduceOp.AVG,
                                     group=group)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduce(g.clone(), op=collective.ReduceOp.AVG,
                                     group=ctx.group), None


def _gelu(x):
    return F.gelu(x, approximate=True)


def moe_ffn(x, gate_w, w1, b1, w2, b2, group=None, capacity_factor=1.25,
            activation=_gelu):
    """Switch FFN over local tokens ``x`` ``[T, D]`` with this rank's
    experts ``w1`` ``[E_local, D, F]``, ``b1`` ``[E_local, F]``, ``w2``
    ``[E_local, F, D]``, ``b2`` ``[E_local, D]`` (all experts without a
    group). Returns ``(y [T, D], aux_loss)``."""
    T, D = x.shape
    e_local = w1.shape[0]
    _, ep = group_rank_size(group)
    E = e_local * ep
    cap = max(1, int(capacity_factor * T / E))
    expert, pos, prob, probs = switch_route(x, gate_w, E, cap)

    frac = torch.nn.functional.one_hot(expert, E).float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    if group is not None:
        frac = _GroupMean.apply(frac, group)
        mean_p = _GroupMean.apply(mean_p, group)
    aux = E * (frac * mean_p).sum()

    keep = pos >= 0
    slot = torch.where(keep, pos, cap)  # the dropped go to a spare slot
    disp = x.new_zeros(E, cap + 1, D).index_put((expert, slot), x)[:, :cap]
    if group is not None:
        # [ep, E_local, cap, D]: block j to rank j; what arrives is this
        # rank's experts' slots from every rank
        disp = all_to_all(disp.reshape(ep, e_local, cap, D), group, 0, 0)
        disp = disp.transpose(0, 1).reshape(e_local, ep * cap, D)
    h = activation(torch.einsum("ecd,edf->ecf", disp, w1) + b1[:, None, :])
    y = torch.einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]
    if group is not None:
        y = y.reshape(e_local, ep, cap, D).transpose(0, 1).contiguous()
        y = all_to_all(y, group, 0, 0).reshape(E, cap, D)
    out = y[expert, torch.where(keep, pos, 0)]
    out = torch.where(keep[:, None], out, 0.0)
    return out * prob[:, None].to(out.dtype), aux
