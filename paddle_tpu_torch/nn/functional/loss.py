"""cross_entropy and binary_cross_entropy_with_logits (counterpart:
``paddle_tpu/nn/functional/loss.py``).

The hard-label path with softmax: ``ignore_index``, ``weight`` and
``reduction`` in mean, sum or none. The logsumexp accumulates in float32
while the exp stays in the logits' dtype, so bf16 logits give a float32
loss without a float32 copy of ``[N, vocab]`` (the reference's fused path).
Soft labels, ``use_softmax=False`` and label smoothing are not ported.
"""
import torch

from ...amp.auto_cast import cast_inputs


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    if soft_label or not use_softmax or label_smoothing != 0.0:
        raise NotImplementedError(
            "cross_entropy: only the hard-label softmax path is ported "
            "(soft_label=False, use_softmax=True, label_smoothing=0)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unsupported reduction {reduction!r}")
    logits, weight = cast_inputs("cross_entropy", input, weight)
    axis = axis % logits.dim()
    idx = label
    if idx.dim() == logits.dim():
        idx = idx.squeeze(axis)
    idx = idx.long()
    valid = idx != ignore_index
    safe_idx = torch.where(valid, idx, 0)
    # stable logsumexp: the max carries no gradient (its two paths cancel)
    m = logits.detach().amax(dim=axis, keepdim=True)
    se = torch.exp(logits - m).sum(dim=axis, dtype=torch.float32)
    lse = m.squeeze(axis).float() + torch.log(se)
    picked = logits.gather(axis, safe_idx.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, lse - picked.float(), 0.0)
    if weight is not None:
        w = weight[safe_idx] * valid
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp_min(1)
    elif reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    return loss


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unsupported reduction {reduction!r}")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """``-(pos_weight * t * log sigmoid(z) + (1 - t) * log sigmoid(-z))``,
    times ``weight``, reduced by ``reduction`` (mean, sum or none): the
    reference's formula, from ``logsigmoid`` both ways."""
    log_sig = torch.nn.functional.logsigmoid(logit)
    log_one_minus = torch.nn.functional.logsigmoid(-logit)
    if pos_weight is not None:
        loss = -(pos_weight * label * log_sig + (1 - label) * log_one_minus)
    else:
        loss = -(label * log_sig + (1 - label) * log_one_minus)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)
