"""ASP, automatic N:M structured sparsity (counterpart:
``paddle_tpu/sparsity``: ``calculate_density``, ``create_mask`` (the
``mask_1d`` greedy search), ``check_mask_1d``, ``check_sparsity``,
``ASPHelper``, ``prune_model`` and ``decorate``).

The masks are searched on the host with the reference's numpy code (a
copy: the port imports nothing of the reference), then held as tensors on
their parameter's device in its dtype. ``reapply_masks`` multiplies each
parameter by its mask in place on the device, so it runs inside a captured
k-step program (the reference's round trip through numpy could not).
"""
import weakref

import numpy as np
import torch

from ..core.dispatch import unwrap

__all__ = ["calculate_density", "create_mask", "check_mask_1d",
           "check_sparsity", "prune_model", "decorate", "ASPHelper"]


def _host(x):
    """``x`` as a numpy array (bfloat16 as float32, which holds it)."""
    x = unwrap(x)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def calculate_density(x):
    """The fraction of non-zeros."""
    arr = _host(x)
    return float((arr != 0).sum() / arr.size)


def _groups(w, m):
    """The last axis of ``w`` in groups of ``m`` (zero-padded), as
    ``(rows, groups, m)``, and the unpadded column count."""
    flat = w.reshape(-1, w.shape[-1])
    cols = flat.shape[1]
    pad = (-cols) % m
    if pad:
        flat = np.pad(flat, ((0, 0), (0, pad)))
    return flat.reshape(flat.shape[0], -1, m), cols


def create_mask(weight, func_name="mask_1d", n=2, m=4):
    """The N:M mask along the last axis: the ``n`` largest magnitudes of
    every ``m`` consecutive elements kept (``MaskAlgo.MASK_1D``)."""
    w = _host(weight)
    groups, cols = _groups(w, m)
    mask = np.zeros_like(groups)
    idx = np.argsort(-np.abs(groups), axis=-1)[..., :n]
    np.put_along_axis(mask, idx, 1.0, axis=-1)
    mask = mask.reshape(groups.shape[0], -1)[:, :cols].reshape(w.shape)
    return mask.astype(w.dtype)


def check_mask_1d(mat, n=2, m=4):
    """Whether every group of ``m`` along the last axis has at most ``n``
    non-zeros."""
    groups, _ = _groups(_host(mat), m)
    return bool(((groups != 0).sum(-1) <= n).all())


def check_sparsity(mat, func_name="check_mask_1d", n=2, m=4):
    return check_mask_1d(mat, n, m)


def _supported(p):
    # the matmul-facing weights (2-d and up); biases and norms are skipped
    return not getattr(p, "is_bias", False) and p.dim() >= 2


class ASPHelper:
    """The masks of the pruned parameters, re-applied after optimizer
    steps. Entries hold their parameter weakly: an id alone would alias a
    dead parameter's mask onto a new tensor at the same address."""

    _masks = {}  # id(param) -> (weakref(param), mask tensor)

    @classmethod
    def prune_model(cls, model, n=2, m=4, mask_algo="mask_1d",
                    with_mask=True):
        """Search each supported parameter's mask and zero the pruned
        weights in place; returns ``{id(param): mask}``."""
        for _name, p in model.named_parameters():
            if not _supported(p):
                continue
            mask = torch.from_numpy(create_mask(p, mask_algo, n, m)).to(
                device=p.device, dtype=p.dtype)
            key = id(p)
            cls._masks[key] = (
                weakref.ref(p, lambda _r, _k=key: cls._masks.pop(_k, None)),
                mask)
            with torch.no_grad():
                p.mul_(mask)
        return {k: mask for k, (_, mask) in cls._masks.items()}

    @classmethod
    def _mask_of(cls, p):
        entry = cls._masks.get(id(p))
        if entry is not None and entry[0]() is p:
            return entry[1]
        return None

    @classmethod
    def reapply_masks(cls, params):
        """Multiply each masked parameter by its mask, in place."""
        cls._reapply(params)

    @classmethod
    def _reapply(cls, params, optimizer=None):
        """:meth:`reapply_masks`, and the float32 master that
        ``optimizer`` keeps of a parameter too: the next step computes the
        parameter from it (the reference masks the parameter only, and its
        master brings the pruned weights back: ROADMAP §3)."""
        with torch.no_grad():
            for p in params:
                mask = cls._mask_of(p)
                if mask is None:
                    continue
                p.mul_(mask)
                master = (None if optimizer is None
                          else optimizer._master_of(p))
                if master is not None:
                    master.mul_(mask)


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    return ASPHelper.prune_model(model, n, m, mask_algo, with_mask)


def decorate(optimizer):
    """Re-apply the masks after each of ``optimizer``'s steps."""
    orig_step = optimizer.step

    def step(*a, **k):
        out = orig_step(*a, **k)
        params = [p for g in optimizer._param_groups for p in g["params"]]
        ASPHelper._reapply(params, optimizer)
        return out

    optimizer.step = step
    return optimizer
