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

Channels-last formats run channels-first between two permutes. Not
ported: ``max_pool2d_with_index`` (``return_mask=True``) and
``max_unpool2d``.
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


def _pool_max(x, kernel_size, stride, padding, ceil_mode, nd, data_format,
              return_mask=False):
    if return_mask:
        raise NotImplementedError("return_mask (max_pool2d_with_index) is "
                                  "not ported")
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
    return _pool_max(x, kernel_size, stride, padding, ceil_mode, 2,
                     data_format, return_mask)


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
