"""The common functionals (counterpart:
``paddle_tpu/nn/functional/common.py``): ``linear``, ``embedding``, the
dropouts, ``one_hot``, ``label_smooth``, ``interpolate``/``upsample``,
``unfold``, ``cosine_similarity``, ``bilinear``, ``normalize`` and
``pixel_shuffle``. Plain torch ops: the JAX package left these to XLA.
Each passes its inputs through ``amp.auto_cast.cast_inputs`` under the
reference's op name (``linear`` and ``embedding`` are on the allow list).

``interpolate`` without ``align_corners`` is ``jax.image.resize``'s
algorithm, which the reference calls: nearest takes ``floor((i + 0.5) *
in / out)``; linear and cubic (Keys, a = -0.5) contract each resized axis
with a weight matrix over half-pixel sample points, antialiased when it
shrinks, each column normalized, zero outside the input
(:func:`_resize_weights`). torch's own ``interpolate`` differs in each of
these (nearest's index, cubic's a = -0.75, no normalization).

The dropouts draw their masks from the package's generator for the
input's device; ``alpha_dropout``'s arithmetic after the draw is
:func:`alpha_dropout_from_mask`.

``embedding(sparse=True)`` gives the table a row gradient (the
reference's ``W@GRAD`` as ``SelectedRows``): its backward sums the
cotangents of equal ids (``SelectedRows.merge_add``, K rows for K ids
whatever the duplicates) and adds the result to the table's sparse
gradient (``core.tensor.accumulate_sparse``); the table's dense ``grad``
stays None. The optimizers update those rows only. Under ``grad``, which
touches no leaf, the row gradient is returned instead
(``core.autograd.collect_rows``).
"""
import torch

from ...amp.auto_cast import cast_inputs
from ...core.autograd import collect_rows
from ...core.random import draw_generator
from ...core.selected_rows import SelectedRows
from ...core.tensor import Tensor, accumulate_sparse


__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "one_hot", "label_smooth", "interpolate",
           "upsample", "unfold", "cosine_similarity", "bilinear",
           "normalize", "pixel_shuffle"]


def linear(x, weight, bias=None):
    """y = x @ W + b with the reference's weight layout W: [in, out]."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False):
    """Row lookup; rows whose id is ``padding_idx`` come out as zeros.
    ``sparse=True`` gives ``weight`` (a leaf: a parameter) a row gradient
    instead of a dense one (module docstring). The dense gradient is
    torch's embedding backward, which on the card adds the partial sums of
    an id repeated many times atomically: run-to-run bitwise only under
    ``torch.use_deterministic_algorithms(True)``."""
    table = _leaf(weight)
    (weight,) = cast_inputs("embedding", weight)
    if sparse and torch.is_grad_enabled() and table.requires_grad:
        if not table.is_leaf:
            raise ValueError("embedding(sparse=True) needs a leaf table (a "
                             "parameter) to carry its row gradient")
        return _SparseLookup.apply(weight, x, padding_idx, table)
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def _leaf(weight):
    """The table that carries a row gradient: ``weight``, or the ``Tensor``
    leaf whose alias the ``Tensor`` boundary handed in."""
    fn = weight.grad_fn
    if (fn is not None and fn.name() == "AliasBackward0"
            and type(weight._base) is Tensor):
        return weight._base
    return weight


class _SparseLookup(torch.autograd.Function):
    """The lookup whose backward hands the table a ``SelectedRows``."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx, table):
        ctx.save_for_backward(ids)
        ctx.padding_idx, ctx.table = padding_idx, table
        out = torch.nn.functional.embedding(ids, weight)
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
        return out

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        vals = grad.reshape(flat.shape[0], *grad.shape[ids.dim():])
        if ctx.padding_idx is not None:
            vals = vals.masked_fill((flat == ctx.padding_idx).unsqueeze(-1),
                                    0.0)
        table = ctx.table
        rows = SelectedRows(flat, vals, table.shape[0]).merge_add()
        if not collect_rows(table, rows):  # grad() touches no leaf
            accumulate_sparse(table, rows)
        return None, None, None, None


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Reference dropout semantics (identity in eval mode or at p = 0);
    the keep mask draws from the package's seeded generator for ``x``'s
    device."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    u = torch.rand(shape, generator=draw_generator(x.device),
                   device=x.device)
    keep = u >= p
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Whole channels dropped: one draw a (sample, channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout_from_mask(x, keep, p):
    """``alpha_dropout`` at the keep mask ``keep``: dropped values set to
    SELU's negative saturation, then the affine map that keeps the mean
    and the variance."""
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, alpha_p) + b


def alpha_dropout(x, p=0.5, training=True):
    if not training or p == 0.0:
        return x
    (x,) = cast_inputs("alpha_dropout", x)
    u = torch.rand(x.shape, generator=draw_generator(x.device),
                   device=x.device)
    return alpha_dropout_from_mask(x, u >= p, p)


def one_hot(x, num_classes):
    """float32 rows with a 1 at each id; an id outside ``[0,
    num_classes)`` gives a row of zeros (the reference's
    ``jax.nn.one_hot``). A comparison, not ``torch.nn.functional.one_hot``,
    whose range check reads the ids on the host (no capture)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """``(1 - epsilon) * label + epsilon / K`` over the last axis of K
    classes, or ``+ epsilon * prior_dist`` (a constant: no gradient, as
    the reference closes over it)."""
    (label,) = cast_inputs("label_smooth", label)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist.detach()
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def _triangle(d):
    return (1.0 - d).clamp_min(0.0)


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image``'s ``compute_weight_mat`` at translation 0: the
    ``[n_in, n_out]`` float32 weights of each output sample over the input
    samples."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)  # antialias when shrinking
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_nearest(v, axes, size):
    for ax, n in zip(axes, size):
        m = v.shape[ax]
        if m == n:
            continue
        idx = ((torch.arange(n, dtype=torch.float32, device=v.device) + 0.5)
               * m / n).floor().long()
        v = v.index_select(ax, idx)
    return v


def _resize_separable(v, axes, size, kernel):
    for ax, n in zip(axes, size):
        m = v.shape[ax]
        if m == n:
            continue
        w = _resize_weights(m, n, kernel, v.device).to(v.dtype)
        v = torch.tensordot(v, w, dims=([ax], [0])).movedim(-1, ax)
    return v


def _resize_align_corners(v, axes, size):
    """Separable lerp with the grid's ends on the input's corners: source
    ``i * (in - 1) / (out - 1)``."""
    for ax, n_out in zip(axes, size):
        n_in = v.shape[ax]
        if n_out == 1:
            v = v.index_select(ax, torch.zeros(1, dtype=torch.long,
                                               device=v.device))
            continue
        c = torch.arange(n_out, dtype=torch.float32, device=v.device) * (
            (n_in - 1) / (n_out - 1))
        lo = c.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(0, n_in - 1)
        shape = [1] * v.dim()
        shape[ax] = n_out
        w = (c - lo).to(v.dtype).reshape(shape)
        v = v.index_select(ax, lo) * (1 - w) + v.index_select(ax, hi) * w
    return v


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """Resize the spatial axes (after N, C for ``NC*`` formats, else
    between N and C) to ``size`` or ``floor(in * scale_factor)``; modes
    nearest, (bi/tri)linear, bicubic and area (linear, as the reference
    maps it)."""
    (x,) = cast_inputs("interpolate", x)
    channels_first = len(data_format) > 1 and data_format[1] == "C"
    axes = (list(range(2, x.dim())) if channels_first
            else list(range(1, x.dim() - 1)))
    spatial = [x.shape[a] for a in axes]
    if size is None:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spatial))
        size = [int(s * f) for s, f in zip(spatial, sf)]
    if isinstance(size, torch.Tensor):
        size = size.tolist()
    size = [int(s) for s in size]
    method = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic",
              "trilinear": "linear", "linear": "linear",
              "area": "linear"}[mode]
    if align_corners and mode in ("bilinear", "linear", "trilinear"):
        return _resize_align_corners(x, axes, size)
    if method == "nearest":
        return _resize_nearest(x, axes, size)
    if not x.is_floating_point():
        x = x.float()
    kernel = _triangle if method == "linear" else _keys_cubic
    return _resize_separable(x, axes, size, kernel)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of ``[N, C, H, W]``: ``[N, C * kh * kw, L]``, channel-major
    columns; the first two ``paddings`` pad H and W on both sides."""
    (x,) = cast_inputs("unfold", x)
    ks, st, pd, dl = (_pair(v) for v in (kernel_sizes, strides, paddings,
                                         dilations))
    return torch.nn.functional.unfold(x, ks[:2], dilation=dl[:2],
                                      padding=pd[:2], stride=st[:2])


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``<x1, x2> / max(|x1| |x2|, eps)`` along ``axis``."""
    x1, x2 = cast_inputs("cosine_similarity", x1, x2)
    dot = (x1 * x2).sum(dim=axis)
    na = (x1 * x1).sum(dim=axis).sqrt()
    nb = (x2 * x2).sum(dim=axis).sqrt()
    return dot / (na * nb).clamp_min(eps)


def bilinear(x1, x2, weight, bias=None):
    """``out[b, o] = x1[b] W[o] x2[b] + bias[o]``, ``W: [out, in1,
    in2]``."""
    x1, x2, weight, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def normalize(x, p=2, axis=1, epsilon=1e-12):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    (x,) = cast_inputs("normalize", x)
    nrm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / nrm.clamp_min(epsilon)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    """``[N, C r^2, H, W] -> [N, C, H r, W r]`` (NCHW, as the reference
    reads it whatever ``data_format`` says)."""
    (x,) = cast_inputs("pixel_shuffle", x)
    r = upscale_factor
    n, c, h, w = x.shape
    v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return v.reshape(n, c // (r * r), h * r, w * r)
