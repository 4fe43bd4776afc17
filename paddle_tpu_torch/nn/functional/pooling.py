"""Pooling (counterpart: ``paddle_tpu/nn/functional/pooling.py``).

The reference pools with ``lax.reduce_window`` over explicitly padded
windows; the port computes the same windows with torch's pooling ops.
Where the two conventions part, the reference's wins:

- ``ceil_mode`` extends the trailing pad until ``ceil((n + p0 + p1 - k) /
  s) + 1`` windows fit, and keeps every such window, also one that starts
  in the padding (torch drops that one); such pads are applied with
  ``F.pad`` (``-inf`` for max, zeros for the sums) before an unpadded
  pool.
- ``exclusive=True`` (the default) divides each window's sum by the count
  of its input elements, padding and ceil extension excluded; ``False``
  divides by the whole kernel.
- ``adaptive_avg_pool2d`` averages equal blocks when the output size
  divides the input; otherwise it takes the reference's non-overlapping
  bins ``np.linspace(0, n, out + 1).astype(int)``, which differ from
  torch's (and upstream Paddle's) overlapping floor/ceil windows.

Channels-last formats run channels-first between two permutes.

``max_pool2d_with_index`` (``max_pool2d(..., return_mask=True)``) returns
the pooled output and an int32 mask of flat ``H * W`` argmax indices into
the input, NCHW only, as the reference computes them: the input padded
with ``-inf`` (the bottom and right pads extended so every ``ceil_mode``
window fits), one strided slice a tap, and the argmax over the taps in
``(ky, kx)`` order, so a tie (a window of zeros after a ReLU) takes the
first tap and a padded position (index -1) is never chosen while the
window holds an input. The output is the input gathered at the mask, so
its gradient flows to the argmax positions. ``max_unpool2d`` scatters the
pooled values back to their indices in a zero map of ``output_size`` (by
default ``(in - 1) * stride - 2 * padding + kernel``; an index outside it
is dropped, as the reference's scatter drops it); duplicate indices carry
equal values, so the order of the writes does not matter.
"""
import math

import numpy as np
import torch

from .conv import _ntuple, spatial_pads, torch_pad_arg

F = torch.nn.functional
_MAX = (F.max_pool1d, F.max_pool2d, F.max_pool3d)


def _pool_pads(sizes, kernel, stride, padding, ceil_mode):
    pads = spatial_pads(padding, sizes, kernel, stride)
    if ceil_mode and not isinstance(padding, str):
        ext = []
        for n, (p0, p1), k, s in zip(sizes, pads, kernel, stride):
            out = -(-(n + p0 + p1 - k) // s) + 1
            ext.append((p0, max(p1, (out - 1) * s + k - n - p0)))
        pads = ext
    return pads


def _native_pad(pads, kernel):
    """The padding torch's own argument expresses (even, at most half the
    kernel), or None."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        return tuple(lo for lo, _ in pads)
    return None


def _windows(x, kernel_size, stride, padding, ceil_mode, nd, data_format):
    last = data_format.endswith("C") and data_format[1] != "C"
    if last:
        x = x.movedim(-1, 1)
    ks = _ntuple(kernel_size, nd)
    st = _ntuple(stride if stride is not None else kernel_size, nd)
    pads = _pool_pads(x.shape[2:], ks, st, padding, ceil_mode)
    return x, last, ks, st, pads


def _pool_max(x, kernel_size, stride, padding, ceil_mode, nd, data_format):
    x, last, ks, st, pads = _windows(x, kernel_size, stride, padding,
                                     ceil_mode, nd, data_format)
    native = _native_pad(pads, ks)
    if native is None:
        x = F.pad(x, torch_pad_arg(pads), value=-math.inf)
        native = 0
    out = _MAX[nd - 1](x, ks, st, native)
    return out.movedim(1, -1) if last else out


def _sum_pool(x, ks, st):
    """Window sums (2d and 3d pools take a divisor of 1; 1d runs as 2d)."""
    if x.dim() == 3:
        return F.avg_pool2d(x.unsqueeze(2), (1, *ks), (1, *st),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return pool(x, ks, st, divisor_override=1)


def _pool_avg(x, kernel_size, stride, padding, exclusive, ceil_mode, nd,
              data_format):
    x, last, ks, st, pads = _windows(x, kernel_size, stride, padding,
                                     ceil_mode, nd, data_format)
    native = _native_pad(pads, ks)
    if native is not None and nd > 1:
        pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
        out = pool(x, ks, st, native, count_include_pad=not exclusive)
    elif native is not None:
        out = F.avg_pool1d(x, ks, st, native, count_include_pad=not exclusive)
    else:
        arg = torch_pad_arg(pads)
        out = _sum_pool(F.pad(x, arg), ks, st)
        if exclusive:
            ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = out / _sum_pool(F.pad(ones, arg), ks, st)
        else:
            out = out / float(np.prod(ks))
    return out.movedim(1, -1) if last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCL"):
    return _pool_max(x, kernel_size, stride, padding, ceil_mode, 1,
                     data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW", return_mask=False):
    if return_mask:
        return max_pool2d_with_index(x, kernel_size, stride, padding,
                                     ceil_mode=ceil_mode,
                                     data_format=data_format)
    return _pool_max(x, kernel_size, stride, padding, ceil_mode, 2,
                     data_format)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          ceil_mode=False, data_format="NCHW"):
    """``(out, mask)``: the max pool and its int32 flat argmax indices."""
    if data_format != "NCHW":
        raise ValueError("the mask path is NCHW (the reference's too)")
    if isinstance(padding, str):
        raise ValueError("string padding unsupported with return_mask")
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    n, c, h, w = x.shape
    (pt, pb), (pl, pr) = spatial_pads(padding, (h, w), ks, st)

    def out_dim(size, p0, p1, k, s):
        num = size + p0 + p1 - k
        return -(-num // s) + 1 if ceil_mode else num // s + 1

    ho, wo = out_dim(h, pt, pb, ks[0], st[0]), out_dim(w, pl, pr, ks[1],
                                                       st[1])
    pb = max(pb, (ho - 1) * st[0] + ks[0] - h - pt)
    pr = max(pr, (wo - 1) * st[1] + ks[1] - w - pl)
    with torch.no_grad():
        vp = F.pad(x.detach(), [pl, pr, pt, pb], value=-math.inf)
        iy = torch.arange(-pt, h + pb, device=x.device)
        ix = torch.arange(-pl, w + pr, device=x.device)
        inside = (((iy >= 0) & (iy < h))[:, None]
                  & ((ix >= 0) & (ix < w))[None, :])
        flat = torch.where(inside, iy[:, None] * w + ix[None, :],
                           torch.full_like(inside, -1, dtype=torch.long))
        rows = [slice(ky, ky + (ho - 1) * st[0] + 1, st[0])
                for ky in range(ks[0])]
        cols = [slice(kx, kx + (wo - 1) * st[1] + 1, st[1])
                for kx in range(ks[1])]
        taps = torch.stack([vp[:, :, r, q] for r in rows for q in cols])
        where = torch.stack([flat[r, q] for r in rows for q in cols])
        arg = taps.argmax(dim=0)  # the first tap among ties
        mask = torch.take_along_dim(where[:, None, None].expand(
            -1, n, c, -1, -1), arg[None], dim=0)[0].to(torch.int32)
    src = x.reshape(n, c, h * w)
    out = torch.gather(src, 2, mask.clamp(min=0).reshape(n, c, -1).long())
    return out.reshape(mask.shape), mask


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None):
    """The pooled values written back at ``indices`` in a zero map."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d is NCHW (the reference's too)")
    ks = _ntuple(kernel_size, 2)
    st = _ntuple(stride if stride is not None else kernel_size, 2)
    pad = _ntuple(padding, 2)
    n, c, ho, wo = x.shape
    if output_size is not None:
        h, w = (int(v) for v in output_size[-2:])
    else:
        h = (ho - 1) * st[0] - 2 * pad[0] + ks[0]
        w = (wo - 1) * st[1] - 2 * pad[1] + ks[1]
    idx = torch.as_tensor(indices, device=x.device).reshape(n, c, -1).long()
    # jnp's .at[i].set: a negative index counts from the end, and one
    # outside the map is dropped (here: written to a spare last slot)
    idx = torch.where(idx < 0, idx + h * w, idx)
    idx = torch.where((idx < 0) | (idx >= h * w), h * w, idx)
    out = torch.zeros(n, c, h * w + 1, dtype=x.dtype,
                      device=x.device).scatter(2, idx, x.reshape(n, c, -1))
    return out[:, :, :h * w].reshape(n, c, h, w)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    return _pool_max(x, kernel_size, stride, padding, ceil_mode, 3,
                     data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _pool_avg(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     1, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCHW"):
    return _pool_avg(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     2, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCDHW"):
    return _pool_avg(x, kernel_size, stride, padding, exclusive, ceil_mode,
                     3, data_format)


def _blocks(v, out):
    """[n, c, h, w] -> [n, c, oh, h/oh, ow, w/ow] (divisible sizes)."""
    n, c, h, w = v.shape
    return v.reshape(n, c, out[0], h // out[0], out[1], w // out[1])


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    out = _ntuple(output_size, 2)
    last = data_format != "NCHW"
    v = x.movedim(-1, 1) if last else x
    h, w = v.shape[2:]
    if h % out[0] == 0 and w % out[1] == 0:
        res = _blocks(v, out).mean(dim=(3, 5))
    else:
        hs = np.linspace(0, h, out[0] + 1).astype(int)
        ws = np.linspace(0, w, out[1] + 1).astype(int)
        res = torch.stack([torch.stack(
            [v[:, :, hs[i]:hs[i + 1], ws[j]:ws[j + 1]].mean(dim=(2, 3))
             for j in range(out[1])], dim=-1) for i in range(out[0])],
            dim=-2)
    return res.movedim(1, -1) if last else res


def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    """Equal blocks only, as in the reference."""
    out = _ntuple(output_size, 2)
    last = data_format != "NCHW"
    v = x.movedim(-1, 1) if last else x
    res = _blocks(v, out).amax(dim=(3, 5))
    return res.movedim(1, -1) if last else res


def adaptive_avg_pool1d(x, output_size):
    n, c, length = x.shape
    out = int(output_size)
    return x.reshape(n, c, out, length // out).mean(dim=3)
