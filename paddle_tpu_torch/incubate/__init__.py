"""Incubating APIs (counterpart: ``paddle_tpu/incubate``): the epoch-loop
``auto_checkpoint``, the Switch ``MoELayer``, ``softmax`` (the
functional's), ``ModelAverage`` and ``LookAhead`` (the optimizer
package's), the custom C op loader (``custom_op.load_custom_op``), the
fused masked softmaxes and the segment reductions.

The reference leaves the fused softmaxes and the segment reductions to
XLA's fusion; the port runs them as torch operations on their input's
device. ``softmax_mask_fuse_upper_triangle`` fills the masked logits with
``-1e9`` in ``x``'s dtype, as the reference does. The segment ops keep
the reference's contract: ``segment_ids`` sorted, the output as long as
the last id plus one, that length read on the host (as the reference
reads it), empty segments 0.
"""
import torch

from ..core.tensor import unwrap
from ..nn.functional import softmax  # noqa: F401
from ..ops.math import op, tensor_like
from . import auto_checkpoint, moe  # noqa: F401
from . import fleet as fleet1x  # noqa: F401  (the fleet 1.x facade)
from .custom_op import load_custom_op  # noqa: F401
from .moe import MoELayer  # noqa: F401
from ..optimizer.averaging import LookAhead, ModelAverage  # noqa: F401

__all__ = ["auto_checkpoint", "moe", "MoELayer", "softmax", "ModelAverage",
           "LookAhead", "load_custom_op", "softmax_mask_fuse_upper_triangle",
           "softmax_mask_fuse", "segment_sum", "segment_mean", "segment_max",
           "segment_min"]


@op
def softmax_mask_fuse_upper_triangle(x):
    """Causal masked softmax over the last axis (reference:
    incubate/operators/softmax_mask_fuse_upper_triangle): keys after the
    query's position masked with -1e9."""
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    logits = x.masked_fill(~keep, -1e9)  # -1e9 rounded to x's dtype
    return torch.softmax(logits, dim=-1)


@op
def softmax_mask_fuse(x, mask):
    """softmax(x + mask) over the last axis (reference: the later
    snapshots' fused_softmax_mask_op); ``mask`` broadcasts over the head
    axis: x [B, H, S, S], mask [B, 1, S, S]."""
    return torch.softmax(x + mask, dim=-1)


def _segment_op(data, segment_ids, kind):
    data = tensor_like(unwrap(data), None)
    seg = tensor_like(unwrap(segment_ids), data).to(torch.int64)
    # sorted ids (the reference's contract): the last one sets the length
    n_out = int(seg[-1]) + 1 if seg.shape[0] else 0

    def body(v):
        rows = (n_out,) + tuple(v.shape[1:])
        if kind in ("sum", "mean"):
            out = v.new_zeros(rows).index_add(0, seg, v)
            if kind == "mean":
                cnt = v.new_zeros((n_out,)).index_add(
                    0, seg, v.new_ones((v.shape[0],)))
                out = out / torch.clamp(cnt, min=1.0).reshape(
                    (-1,) + (1,) * (v.dim() - 1))
            return out
        init = float("-inf") if kind == "max" else float("inf")
        idx = seg.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
        out = torch.full(rows, init, dtype=v.dtype, device=v.device)
        out = out.scatter_reduce(0, idx, v, "amax" if kind == "max"
                                 else "amin", include_self=True)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

    body.__name__ = body.__qualname__ = f"segment_{kind}"
    return op(body)(data)


def segment_sum(data, segment_ids):
    """reference: incubate segment_pool (operators/segment_pool_op.cc)."""
    return _segment_op(data, segment_ids, "sum")


def segment_mean(data, segment_ids):
    return _segment_op(data, segment_ids, "mean")


def segment_max(data, segment_ids):
    return _segment_op(data, segment_ids, "max")


def segment_min(data, segment_ids):
    return _segment_op(data, segment_ids, "min")
