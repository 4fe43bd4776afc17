"""The statistics and manipulation tail of the Tensor methods (counterpart:
``paddle_tpu/ops/extras.py``): torch operations, ``Tensor``s in and out
(``math.op``). ``median`` and ``quantile`` interpolate between the middle
values as numpy does (torch's ``median`` takes the lower one);
``kthvalue`` and ``mode`` break ties as the reference does (a stable
sort); ``mode`` and ``unique_consecutive`` compute on the host (their
sizes or their run lengths are the data's), as the reference's
``unique_consecutive`` does.
"""
import numpy as np
import torch

from ..core.tensor import host_array
from .math import floating, op, pair, tensor_like

__all__ = [
    "median", "kthvalue", "mode", "quantile", "nanmedian",
    "histogram", "bincount", "unique_consecutive", "diff",
    "trace", "kron", "outer", "cross", "diagonal", "rot90",
    "searchsorted", "bucketize", "take", "lerp", "trunc", "frac",
    "nanmean", "nansum", "deg2rad", "rad2deg", "gcd", "lcm", "heaviside",
    "digamma", "lgamma", "conj", "real", "imag", "mv", "dist", "increment",
    "unbind", "broadcast_tensors", "multiplex", "crop", "squared_l2_norm",
    "cvm", "data_norm", "fsp_matrix", "partial_concat", "partial_sum",
]


def _quantile(fn, x, q, axis, keepdim):
    """numpy's quantile (linear) over ``axis`` (None: all; a tuple: those
    axes together)."""
    x = floating(x)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), q, dim=0)
        if keepdim:
            out = out.reshape(tuple(q.shape) + (1,) * x.dim())
        return out
    if isinstance(axis, (list, tuple)):
        picked = sorted(a % x.dim() for a in axis)
        rest = [d for d in range(x.dim()) if d not in picked]
        moved = x.permute(*rest, *picked).reshape(
            [x.shape[d] for d in rest] + [-1])
        out = fn(moved, q, dim=-1)
        if keepdim:
            shape = list(out.shape)
            for a in picked:
                shape.insert(a + (q.dim() > 0), 1)
            out = out.reshape(shape)
        return out
    return fn(x, q, dim=int(axis), keepdim=keepdim)


@op
def median(x, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


@op
def nanmedian(x, axis=None, keepdim=False):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


@op
def quantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, q, axis, keepdim)


@op
def kthvalue(x, k, axis=-1, keepdim=False):
    """(values, int64 indices) of the k-th smallest along ``axis`` (k
    from 1), ties in a stable order."""
    idx = torch.argsort(x, dim=axis, stable=True).narrow(axis, k - 1, 1)
    vals = torch.take_along_dim(x, idx, axis)
    if not keepdim:
        idx, vals = idx.squeeze(axis), vals.squeeze(axis)
    return vals, idx


@op
def mode(x, axis=-1, keepdim=False):
    """(values, int64 indices): the most frequent value along ``axis`` (the
    smallest of those tied) and where it first occurs."""
    arr = np.moveaxis(host_array(x), axis, -1)
    flat = arr.reshape(-1, arr.shape[-1])
    vals = np.empty(flat.shape[0], arr.dtype)
    idx = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        uniq, counts = np.unique(row, return_counts=True)
        vals[i] = uniq[np.argmax(counts)]
        idx[i] = int(np.argmax(row == vals[i]))
    shape = arr.shape[:-1]
    vals = torch.as_tensor(vals.reshape(shape), device=x.device)
    idx = torch.as_tensor(idx.reshape(shape), device=x.device)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@op
def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    """int64 counts in ``bins`` equal bins over [min, max] (the data's
    range when both are 0)."""
    xf = x.reshape(-1).float()
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = xf.min().item(), xf.max().item()
    return torch.histc(xf, bins=bins, min=lo, max=hi).to(torch.int64)


@op
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x.reshape(-1).long(), weights=None if weights is
                          None else weights.reshape(-1), minlength=minlength)


@op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    out = torch.unique_consecutive(x, return_inverse=True,
                                   return_counts=True, dim=axis)
    res = (out[0],)
    if return_inverse:
        res += (out[1].reshape(-1).long(),)
    if return_counts:
        res += (out[2].long(),)
    return res if len(res) > 1 else out[0]


@op
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


@op
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@op
def kron(x, y):
    return torch.kron(*pair(x, y))


@op
def outer(x, y):
    x, y = pair(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op
def cross(x, y, axis=None):
    """The cross product along ``axis`` (default: the first axis of size
    3)."""
    if axis is None:
        shape = list(x.shape)
        if 3 not in shape:
            raise ValueError(f"cross with axis=None needs a dimension of "
                             f"size 3; got shape {shape}")
        axis = shape.index(3)
    return torch.linalg.cross(*pair(x, y), dim=axis)


@op
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@op
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@op
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    values = tensor_like(values, sorted_sequence)
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


@op
def take(x, index, mode="raise"):
    """Flat-index gather: ``wrap`` takes indices modulo the size, the
    other modes clip them to [-n, n) (the reference cannot raise)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = tensor_like(index, x).long()
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(-n, n - 1)
    idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx.reshape(-1)].reshape(idx.shape)


@op
def lerp(x, y, weight):
    x, y = pair(x, y)
    return x + tensor_like(weight, x) * (y - x)


@op
def trunc(x):
    return torch.trunc(x)


@op
def frac(x):
    return x - torch.trunc(x)


@op
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(x, dim=axis, keepdim=keepdim)


@op
def nansum(x, axis=None, keepdim=False):
    return torch.nansum(x, dim=axis, keepdim=keepdim)


@op
def deg2rad(x):
    return torch.deg2rad(floating(x))


@op
def rad2deg(x):
    return torch.rad2deg(floating(x))


@op
def gcd(x, y):
    return torch.gcd(*pair(x, y))


@op
def lcm(x, y):
    return torch.lcm(*pair(x, y))


@op
def heaviside(x, y):
    return torch.heaviside(*pair(x, y))


@op
def digamma(x):
    return torch.digamma(x)


@op
def lgamma(x):
    return torch.lgamma(x)


@op
def conj(x):
    return torch.conj(x).resolve_conj()


@op
def real(x):
    return torch.real(x) if x.is_complex() else x.clone()


@op
def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@op
def mv(x, vec):
    return torch.mv(x, vec)


@op
def dist(x, y, p=2):
    x, y = pair(x, y)
    d = (x - y).abs()
    pv = float(p)
    if pv == float("inf"):
        return d.max()
    if pv == float("-inf"):
        return d.min()
    if pv == 0:
        return (d != 0).to(x.dtype).sum()
    return d.pow(pv).sum().pow(1.0 / pv)


@op
def increment(x, value=1.0):
    return x + value


@op
def unbind(x, axis=0):
    return list(torch.unbind(x, dim=axis))


@op
def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*inputs))


@op
def multiplex(inputs, index):
    """out[i] = inputs[index[i]][i]."""
    stacked = torch.stack(list(inputs), 0)
    sel = index.reshape(-1).long()
    return stacked[sel, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


@op
def crop(x, shape=None, offsets=None):
    """A static slice at ``offsets`` of ``shape`` (-1 keeps the rest of an
    axis; no offsets: zeros)."""
    in_shape = list(x.shape)
    shape = in_shape if shape is None else [
        int(s) for s in (shape.tolist() if isinstance(shape, torch.Tensor)
                         else shape)]
    offsets = [0] * len(in_shape) if offsets is None else [
        int(o) for o in (offsets.tolist() if isinstance(offsets, torch.Tensor)
                         else offsets)]
    shape = [in_shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@op
def squared_l2_norm(x):
    return torch.sum(torch.square(x))


@op
def cvm(input, cvm_input=None, use_cvm=True):  # noqa: A002
    """With ``use_cvm`` the first two columns (show, click) become
    log(show+1) and log(click+1) - log(show+1); else they are dropped."""
    if use_cvm:
        c0 = torch.log(input[:, 0:1] + 1.0)
        c1 = torch.log(input[:, 1:2] + 1.0) - c0
        return torch.cat([c0, c1, input[:, 2:]], dim=1)
    return input[:, 2:]


@op
def data_norm(input, batch_size, batch_sum, batch_square_sum,  # noqa: A002
              epsilon=1e-4, do_model_average_for_mean_and_var=True,
              update_stats=True, summary_decay_rate=0.9999999):
    """(x - batch_sum/batch_size) * sqrt(batch_size / (batch_square_sum +
    epsilon)) per feature; ``update_stats`` folds this batch into the
    three summaries in place, decayed by ``summary_decay_rate``."""
    mean = batch_sum / batch_size
    scale = torch.sqrt(batch_size / (batch_square_sum + epsilon))
    out = (input - mean) * scale
    if update_stats:
        with torch.no_grad():
            v = input.detach()
            dr = summary_decay_rate
            batch_size.copy_(batch_size * dr + v.shape[0])
            batch_sum.copy_(batch_sum * dr + v.sum(0))
            batch_square_sum.copy_(batch_square_sum * dr + (v ** 2).sum(0))
    return out


@op
def fsp_matrix(x, y):
    """out[n, i, j] = mean over (h, w) of x[n, i, h, w] * y[n, j, h, w]."""
    h, w = x.shape[2], x.shape[3]
    return torch.einsum("nihw,njhw->nij", x, y) / (h * w)


def _columns(v, start_index, length):
    st = start_index + v.shape[1] if start_index < 0 else start_index
    end = v.shape[1] if length < 0 else st + length
    return v[:, st:end]


@op
def partial_concat(xs, start_index=0, length=-1):
    return torch.cat([_columns(v, start_index, length) for v in xs], dim=1)


@op
def partial_sum(xs, start_index=0, length=-1):
    parts = [_columns(v, start_index, length) for v in xs]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out

