"""The loss functionals (counterpart: ``paddle_tpu/nn/functional/loss.py``),
all 28, in torch ops with the reference's formulas and branches.

``cross_entropy``: with softmax, hard labels and no smoothing it takes
the fused path (the logsumexp accumulates in float32 while the exp stays
in the logits' dtype, so bf16 logits give a float32 loss without a
float32 copy of ``[N, vocab]``); otherwise it computes a float32
log-softmax (or the log of the given probabilities with
``use_softmax=False``) and takes soft labels (smoothed by
``label_smoothing / K`` when asked) or hard labels (smoothed toward the
row's mean log-probability). The label carries no gradient, as the
reference gives it none.

Each passes its positional tensors through ``amp.auto_cast.cast_inputs``
under the reference's op name (``bce``, ``bce_with_logits``, ``mse_loss``,
``l1_loss`` and ``kl_div`` are block-listed: they compute in float32).

The sampling losses draw from the package's generator for the input's
device, or from a generator seeded with ``seed``: ``nce`` and
``sampled_softmax_with_cross_entropy`` compute from their draws in
:func:`nce_from_samples` and :func:`sampled_softmax_from_samples`.
"""
import math

import torch

from ...amp.auto_cast import cast_inputs
from ...core.random import draw_generator

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "square_error_cost", "sigmoid_focal_loss", "ctc_loss", "rank_loss",
    "margin_rank_loss", "huber_loss", "log_loss", "bpr_loss", "npair_loss",
    "center_loss", "nce", "sampled_softmax_with_cross_entropy",
    "hsigmoid_loss", "teacher_student_sigmoid_loss", "hinge_loss"]

_F = torch.nn.functional


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unsupported reduction {reduction!r}")


def _hard_index(label, ndim, axis):
    idx = label
    if idx.dim() == ndim:
        idx = idx.squeeze(axis)
    return idx.long()


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unsupported reduction {reduction!r}")
    logits, label, weight = cast_inputs("cross_entropy", input, label,
                                        weight)
    label = label.detach()
    axis = axis % logits.dim()
    if use_softmax and not soft_label and label_smoothing == 0.0:
        return _fused_hard(logits, label, weight, ignore_index, reduction,
                           axis)
    if use_softmax:
        logp = torch.log_softmax(logits.float(), dim=axis)
    else:
        logp = torch.log(logits.float().clamp_min(1e-30))
    if soft_label:
        tgt = label.to(logp.dtype)
        if label_smoothing > 0.0:
            k = logp.shape[axis]
            tgt = (1 - label_smoothing) * tgt + label_smoothing / k
        return _reduce(-(tgt * logp).sum(dim=axis), reduction)
    idx = _hard_index(label, logp.dim(), axis)
    valid = idx != ignore_index
    safe_idx = torch.where(valid, idx, 0)
    picked = logp.gather(axis, safe_idx.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        picked = ((1 - label_smoothing) * picked
                  + label_smoothing * logp.mean(dim=axis))
    loss = -torch.where(valid, picked, 0.0)
    w = None
    if weight is not None:
        w = weight[safe_idx] * valid
        loss = loss * w
    if reduction == "mean":
        denom = w.sum() if w is not None else valid.sum()
        return loss.sum() / denom.clamp_min(1)
    return _reduce(loss, reduction)


def _fused_hard(logits, label, weight, ignore_index, reduction, axis):
    idx = _hard_index(label, logits.dim(), axis)
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


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100, return_softmax=False):
    """The per-sample loss with ``axis`` kept (size 1), and the softmax
    with ``return_softmax``."""
    loss = cross_entropy(logits, label, reduction="none",
                         soft_label=soft_label, axis=axis,
                         ignore_index=ignore_index).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean"):
    """``-input[label]`` over log-probabilities (the last axis)."""
    logp, weight = cast_inputs("nll_loss", input, weight)
    idx = _hard_index(label.detach(), logp.dim(), -1)
    valid = idx != ignore_index
    safe_idx = torch.where(valid, idx, 0)
    picked = logp.gather(-1, safe_idx.unsqueeze(-1)).squeeze(-1)
    loss = -torch.where(valid, picked, 0.0)
    if weight is not None:
        w = weight[safe_idx] * valid
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum().clamp_min(1)
    elif reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    a, b = cast_inputs("mse_loss", input, label)
    return _reduce((a - b).square(), reduction)


def l1_loss(input, label, reduction="mean"):  # noqa: A002
    a, b = cast_inputs("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    a, b = cast_inputs("smooth_l1_loss", input, label)
    d = (a - b).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    p, t, weight = cast_inputs("bce", input, label, weight)
    p = p.clamp(1e-12, 1.0 - 1e-12)
    loss = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """``-(pos_weight * t * log sigmoid(z) + (1 - t) * log sigmoid(-z))``,
    times ``weight``, reduced by ``reduction`` (mean, sum or none): the
    reference's formula, from ``logsigmoid`` both ways."""
    logit, label, weight, pos_weight = cast_inputs(
        "bce_with_logits", logit, label, weight, pos_weight)
    log_sig = _F.logsigmoid(logit)
    log_one_minus = _F.logsigmoid(-logit)
    if pos_weight is not None:
        loss = -(pos_weight * label * log_sig + (1 - label) * log_one_minus)
    else:
        loss = -(label * log_sig + (1 - label) * log_one_minus)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean"):  # noqa: A002
    """``label * (log label - input)``; ``batchmean`` divides the sum by
    the batch."""
    logp, t = cast_inputs("kl_div", input, label)
    loss = t * (torch.log(t.clamp_min(1e-30)) - logp)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    a, b, t = cast_inputs("margin_ranking_loss", input, other, label)
    return _reduce((-t * (a - b) + margin).clamp_min(0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    a, t = cast_inputs("hinge_embedding_loss", input, label)
    loss = torch.where(t == 1, a, (margin - a).clamp_min(0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    a, b, t = cast_inputs("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                             * torch.linalg.vector_norm(b, dim=-1)
                             ).clamp_min(1e-12)
    loss = torch.where(t == 1, 1 - cos, (cos - margin).clamp_min(0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, reduction="mean"):
    a, pos, neg = cast_inputs("triplet_margin_loss", input, positive,
                              negative)
    dp = (((a - pos).abs() ** p).sum(-1) + epsilon) ** (1 / p)
    dn = (((a - neg).abs() ** p).sum(-1) + epsilon) ** (1 / p)
    return _reduce((dp - dn + margin).clamp_min(0.0), reduction)


def square_error_cost(input, label):  # noqa: A002
    a, b = cast_inputs("square_error_cost", input, label)
    return (a - b).square()


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    z, t, normalizer = cast_inputs("sigmoid_focal_loss", logit, label,
                                   normalizer)
    p = torch.sigmoid(z)
    ce = -(t * _F.logsigmoid(z) + (1 - t) * _F.logsigmoid(-z))
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = a_t * (1 - p_t) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``[T, B, C]`` logits (log-softmax applied here, as the
    reference's warpctc takes unnormalized activations), ``labels`` ``[B,
    S]`` and the lengths ``[B]``: the log-domain alpha recursion over the
    blank-interleaved labels, one step a frame, frozen past each input's
    length. ``mean`` divides each sample by its label length before the
    batch mean (the reference's)."""
    (logits,) = cast_inputs("warpctc", log_probs)
    logp = torch.log_softmax(logits.float(), dim=-1)
    T, B, _ = logp.shape
    S = labels.shape[1]
    Lp = 2 * S + 1
    neg_inf = -1e30
    dev = logp.device
    lbl = labels.to(dev).long()
    in_len = input_lengths.to(dev).long()
    lb_len = label_lengths.to(dev).long()
    ext = torch.full((B, Lp), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lbl
    pos = torch.arange(Lp, device=dev)
    valid_s = pos[None, :] < (2 * lb_len[:, None] + 1)
    prev2 = torch.cat([torch.full((B, 2), blank - 1, dtype=torch.long,
                                  device=dev), ext[:, :-2]], dim=1)
    can_skip = (pos[None, :] % 2 == 1) & (ext != prev2)
    pad1 = torch.full((B, 1), neg_inf, device=dev)
    pad2 = torch.full((B, 2), neg_inf, device=dev)

    first = logp[0].gather(1, ext)
    alpha = torch.full((B, Lp), neg_inf, device=dev)
    alpha = torch.cat([first[:, :1],
                       torch.where(lb_len[:, None] > 0, first[:, 1:2],
                                   neg_inf), alpha[:, 2:]], dim=1)
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2_a = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]],
                                                  dim=1), neg_inf)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2_a)
        new = torch.where(valid_s, merged + logp[t].gather(1, ext), neg_inf)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = alpha.gather(1, (2 * lb_len)[:, None])[:, 0]
    last2 = alpha.gather(1, (2 * lb_len - 1).clamp_min(0)[:, None])[:, 0]
    last2 = torch.where(lb_len > 0, last2, neg_inf)
    nll = -torch.logaddexp(last, last2)
    if norm_by_times:
        nll = nll / in_len.float().clamp_min(1.0)
    if reduction == "mean":
        return (nll / lb_len.float().clamp_min(1.0)).mean()
    return _reduce(nll, reduction)


def _log1p_exp_neg_abs(o):
    return torch.log1p(torch.exp(-o.abs()))


def rank_loss(label, left, right):
    """RankNet: ``-label (left - right) + log(1 + exp(left - right))``, in
    its stable form."""
    lab, l, r = cast_inputs("rank_loss", label, left, right)
    o = l - r
    return o.clamp_min(0.0) - lab * o + _log1p_exp_neg_abs(o)


def margin_rank_loss(label, left, right, margin=0.1):
    lab, l, r = cast_inputs("margin_rank_loss", label, left, right)
    return (-lab * (l - r) + margin).clamp_min(0.0)


def huber_loss(input, label, delta):  # noqa: A002
    x, y = cast_inputs("huber_loss", input, label)
    d = y - x
    ad = d.abs()
    return torch.where(ad <= delta, 0.5 * d * d,
                       delta * ad - 0.5 * delta * delta)


def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    p, y = cast_inputs("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1.0 - y) * torch.log(
        1.0 - p + epsilon)


def bpr_loss(input, label):  # noqa: A002
    """``-1/(D-1) sum_{j != label} log sigmoid(x[label] - x[j])`` a
    row."""
    (x,) = cast_inputs("bpr_loss", input)
    n = x.shape[1]
    idx = label.detach().reshape(-1).long()
    pos = x.gather(1, idx[:, None])
    logsig = _F.logsigmoid(pos - x)
    mask = (idx[:, None] == torch.arange(n, device=x.device)).to(x.dtype)
    return -(logsig * (1.0 - mask)).sum(1, keepdim=True) / (n - 1)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """An L2 term on the embeddings plus the soft-label cross entropy over
    the anchor-positive similarities, labels equal within a class."""
    a, p = cast_inputs("npair_loss", anchor, positive)
    lab = labels.detach().reshape(-1)
    eq = (lab[:, None] == lab[None, :]).to(a.dtype)
    soft = eq / eq.sum(1, keepdim=True)
    l2 = ((a * a).sum(1).mean() + (p * p).sum(1).mean()) * 0.25 * l2_reg
    logp = torch.log_softmax(a @ p.T, dim=-1)
    return l2 + (-(soft * logp).sum(1)).mean()


def center_loss(input, label, num_classes, alpha, centers,  # noqa: A002
                update_center=True):
    """``0.5 |x - c[label]|^2`` a row (``[N, 1]``); with
    ``update_center`` the ``[num_classes, D]`` centers move in place,
    ``c -= alpha * sum_per_class(c - x) / (1 + count)``."""
    x, c = cast_inputs("center_loss", input, centers)
    lab = label.detach().reshape(-1).long()
    diff = x - c[lab]
    out = 0.5 * (diff * diff).sum(1, keepdim=True)
    if update_center:
        with torch.no_grad():
            d = c[lab] - x
            sums = torch.zeros_like(c).index_add_(0, lab, d)
            counts = torch.zeros(c.shape[0], dtype=x.dtype,
                                 device=x.device).index_add_(
                0, lab, torch.ones_like(lab, dtype=x.dtype))
            centers.copy_(c - alpha * sums / (1.0 + counts)[:, None])
    return out


def _seeded_generator(seed, device):
    if seed is None:
        return draw_generator(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def nce_from_samples(input, label, weight, bias, samples, q,  # noqa: A002
                     num_neg_samples):
    """``nce`` at the drawn negative classes ``samples`` ``[S]`` with
    their sampler's probabilities ``q`` ``[C]``: ``[B, 1]``."""
    x, w, bias = cast_inputs("nce", input, weight, bias)
    lab = label.detach().reshape(-1).long()
    k = float(num_neg_samples)
    s_pos = (x * w[lab]).sum(1)
    s_neg = x @ w[samples].T
    if bias is not None:
        s_pos = s_pos + bias[lab]
        s_neg = s_neg + bias[samples]
    pos_logit = s_pos - torch.log(k * q[lab] + 1e-20)
    neg_logit = s_neg - torch.log(k * q[samples] + 1e-20)[None, :]
    loss = (-_F.logsigmoid(pos_logit)
            - _F.logsigmoid(-neg_logit).sum(1))
    return loss[:, None]


def nce(input, label, weight, bias=None, num_total_classes=None,  # noqa: A002
        num_neg_samples=10, sampler="uniform", custom_dist=None, seed=None):
    """Noise-contrastive estimation, ``[B, 1]``: ``num_neg_samples``
    classes drawn uniformly, log-uniformly (``P(k) ∝ log((k + 2) / (k +
    1))``) or from ``custom_dist``."""
    dev = input.device
    c = int(num_total_classes if num_total_classes is not None
            else weight.shape[0])
    gen = _seeded_generator(seed, dev)
    if custom_dist is not None or sampler == "log_uniform":
        if custom_dist is not None:
            probs = torch.as_tensor(custom_dist, dtype=torch.float32,
                                    device=dev)
        else:
            ks = torch.arange(c, dtype=torch.float32, device=dev)
            probs = torch.log((ks + 2.0) / (ks + 1.0))
        q = probs / probs.sum()
        samples = torch.multinomial(q, num_neg_samples, replacement=True,
                                    generator=gen)
    else:
        samples = torch.randint(0, c, (num_neg_samples,), generator=gen,
                                device=dev)
        q = torch.full((c,), 1.0 / c, device=dev)
    return nce_from_samples(input, label, weight, bias, samples, q,
                            num_neg_samples)


def sampled_softmax_from_samples(logits, label, samples, num_samples):
    """``sampled_softmax_with_cross_entropy`` at the drawn classes
    ``samples`` ``[S]``: the true class and the samples (accidental hits
    masked out), each logit corrected by ``log(S / C)``; ``[N, 1]``."""
    (lg,) = cast_inputs("sampled_softmax_with_cross_entropy", logits)
    lab = label.detach()
    if lab.dim() == 2:
        lab = lab[:, 0]
    lab = lab.long()
    c = lg.shape[1]
    true_logit = lg.gather(1, lab[:, None])
    samp_logit = lg[:, samples]
    samp_logit = torch.where(samples[None, :] == lab[:, None],
                             float("-inf"), samp_logit)
    corr = math.log(num_samples * (1.0 / c))
    cat = torch.cat([true_logit - corr, samp_logit - corr], dim=1)
    return -torch.log_softmax(cat, dim=1)[:, :1]


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       seed=None):
    """Softmax cross entropy over the true class and ``num_samples``
    classes drawn uniformly (with replacement), ``[N, 1]``."""
    gen = _seeded_generator(seed, logits.device)
    samples = torch.randint(0, logits.shape[1], (num_samples,),
                            generator=gen, device=logits.device)
    return sampled_softmax_from_samples(logits, label, samples, num_samples)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid, ``[N, 1]``: the summed sigmoid cross entropy
    along each class's path. The default tree codes class ``c`` as ``c +
    num_classes``, whose bit ``j`` is node ``(code >> (j + 1)) - 1``'s
    target ``(code >> j) & 1``; ``path_table``/``path_code`` (``[N, L]``,
    a node below 0 pads) give another tree."""
    x, w, bias = cast_inputs("hsigmoid_loss", input, weight, bias)
    lab = label.detach().reshape(-1).long().to(x.device)
    if path_table is not None:
        tbl = path_table.to(x.device).long()
        valid = tbl >= 0
        idxs = tbl.clamp_min(0)
        bits = torch.where(valid, path_code.to(x.device).float(), 0.0)
    else:
        max_len = int(2 * num_classes - 1).bit_length() - 1
        code = lab + num_classes
        js = torch.arange(max_len, device=x.device)
        idxs = (code[:, None] >> (js[None, :] + 1)) - 1
        bits = ((code[:, None] >> js[None, :]) & 1).float()
        length = torch.floor(torch.log2(code.float() + 0.5)).long()
        valid = js[None, :] < length[:, None]
        idxs = torch.where(valid, idxs, 0)
    logits = torch.einsum("nd,nld->nl", x, w[idxs])
    if bias is not None:
        logits = logits + bias[idxs]
    sce = logits.clamp_min(0.0) - logits * bits + _log1p_exp_neg_abs(logits)
    return torch.where(valid, sce, 0.0).sum(1, keepdim=True)


def teacher_student_sigmoid_loss(input, label,  # noqa: A002
                                 soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """CTR distillation: ``label < -1``: BCE(x, 0); ``-1 <= label < 0``:
    BCE(x, 1); ``0 <= label < 1``: BCE(x, 0) + BCE(x, label); ``label >=
    1``: BCE(x, 1) + BCE(x, label - 1)."""
    x, lab = cast_inputs("teacher_student_sigmoid_loss", input, label)
    x = x.clamp(soft_max_lower_bound, soft_max_up_bound)
    base = x.clamp_min(0.0) + _log1p_exp_neg_abs(x)
    bce1 = base - x
    soft = torch.where(lab < 1.0, base - x * lab, base - x * (lab - 1.0))
    return torch.where(lab < -1.0, base, torch.where(
        lab < 0.0, bce1, torch.where(lab < 1.0, base + soft, bce1 + soft)))


def hinge_loss(input, label):  # noqa: A002
    """``max(0, 1 - (2 y - 1) x)`` with ``y`` in {0, 1}."""
    x, y = cast_inputs("hinge_loss", input, label)
    return (1.0 - (2.0 * y - 1.0) * x).clamp_min(0.0)
