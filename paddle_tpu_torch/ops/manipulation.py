"""Shape, indexing and combination ops (counterpart:
``paddle_tpu/ops/manipulation.py``), ``getitem`` and ``setitem`` among
them: torch operations with their gradients, ``Tensor``s in and out
(``math.op``). Views stay views where torch makes them (``reshape`` of a
contiguous tensor, ``getitem`` with basic indices), so a captured program
reads the buffer it was captured from. ``masked_select`` and ``unique``
have a data-dependent size and read it on the host, as the reference's
do.
"""
import builtins

import numpy as np
import torch

from ..core.tensor import host_array, unwrap
from .math import op, shape_list, tensor_like

__all__ = [
    "reshape", "flatten", "transpose", "moveaxis", "swapaxes", "squeeze",
    "unsqueeze", "concat", "stack", "unstack", "split", "chunk", "tile",
    "expand", "expand_as", "broadcast_to", "flip", "roll", "slice",
    "strided_slice", "gather", "gather_nd", "take_along_axis", "scatter",
    "scatter_nd_add", "put_along_axis", "index_select", "index_sample",
    "masked_select", "masked_fill", "pad", "unique", "assign", "numel",
    "shape", "meshgrid", "repeat_interleave", "one_hot", "getitem",
    "setitem"]


def _axis(axis):
    return int(unwrap(axis).item()) if isinstance(axis, torch.Tensor) \
        else int(axis)


@op
def reshape(x, shape):
    return x.reshape(shape_list(shape))


@op
def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


@op
def transpose(x, perm=None):
    if perm is None:
        return x.permute(*reversed(range(x.dim())))
    return x.permute(*[int(p) for p in perm])


@op
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@op
def squeeze(x, axis=None):
    """Drops the size-1 axes (of ``axis`` only, where given); an axis of
    another size stays."""
    if axis is None:
        return torch.squeeze(x)
    picked = tuple(a for a in (axis if isinstance(axis, (list, tuple))
                               else [axis]) if x.shape[a] == 1)
    return torch.squeeze(x, picked) if picked else x


@op
def unsqueeze(x, axis):
    picked = axis if isinstance(axis, (list, tuple)) else [axis]
    out = x
    nd = x.dim() + len(picked)
    for a in sorted(int(a) % nd for a in picked):
        out = out.unsqueeze(a)
    return out


@op
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=_axis(axis))


@op
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=int(axis))


@op
def unstack(x, axis=0, num=None):
    if num is not None and num != x.shape[axis]:
        raise ValueError(f"unstack: num={num} but axis {axis} has size "
                         f"{x.shape[axis]}")
    return list(torch.unbind(x, dim=axis))


@op
def split(x, num_or_sections, axis=0):
    """``num_or_sections`` equal parts (an int), or parts of the listed
    sizes (one of them may be -1: the rest)."""
    axis = _axis(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: axis {axis} of size {total} does not "
                             f"divide into {num_or_sections} parts")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    sections = [int(s) for s in num_or_sections]
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


@op
def tile(x, repeat_times):
    return torch.tile(x, tuple(shape_list(repeat_times)))


@op
def expand(x, shape):
    """Broadcast to ``shape``; -1 keeps that axis."""
    target = shape_list(shape)
    off = len(target) - x.dim()
    target = [x.shape[i - off] if s == -1 else s
              for i, s in enumerate(target)]
    return x.expand(target)


@op
def expand_as(x, y):
    return x.expand(tensor_like(y, x).shape)


@op
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(shape_list(shape)))


@op
def flip(x, axis):
    return torch.flip(x, list(axis) if isinstance(axis, (list, tuple))
                      else [axis])


@op
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@op
def slice(x, axes, starts, ends):  # noqa: A001
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(int(st), int(en))
    return x[tuple(idx)]


@op
def strided_slice(x, axes, starts, ends, strides):
    """numpy's ``x[start:end:stride]`` on each listed axis; a negative
    stride (which torch's slices do not take) gathers its indices."""
    idx = [builtins.slice(None)] * x.dim()
    out = x
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        if sd < 0:
            picked = range(*builtins.slice(st, en, sd).indices(x.shape[ax]))
            out = out.index_select(ax, torch.tensor(list(picked),
                                                    dtype=torch.int64,
                                                    device=x.device))
        else:
            idx[ax] = builtins.slice(st, en, sd)
    return out[tuple(idx)]


@op
def gather(x, index, axis=0):
    index = tensor_like(index, x).long()
    if index.dim() == 0:
        return torch.index_select(x, axis, index.reshape(1)).squeeze(axis)
    if index.dim() == 1:
        return torch.index_select(x, axis, index)
    return torch.index_select(x, axis, index.reshape(-1)).reshape(
        x.shape[:axis] + index.shape + x.shape[axis + 1:])


@op
def gather_nd(x, index):
    index = tensor_like(index, x).long()
    return x[tuple(index.movedim(-1, 0))]


@op
def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, tensor_like(indices, x).long(), axis)


@op
def scatter(x, index, updates, overwrite=True):
    """Rows ``index`` of ``x`` set to ``updates`` (added with
    ``overwrite=False``)."""
    index = tensor_like(index, x).long()
    updates = tensor_like(updates, x).to(x.dtype)
    if overwrite:
        return x.index_put((index,), updates)
    return x.index_put((index,), updates, accumulate=True)


@op
def scatter_nd_add(x, index, updates):
    index = tensor_like(index, x).long()
    return x.index_put(tuple(index.movedim(-1, 0)),
                       tensor_like(updates, x).to(x.dtype), accumulate=True)


@op
def put_along_axis(x, indices, values, axis):
    indices = tensor_like(indices, x).long()
    values = tensor_like(values, x).to(x.dtype).expand(indices.shape)
    return torch.scatter(x, axis, indices, values)


def index_select(x, index, axis=0):
    return gather(x, index, axis)


@op
def index_sample(x, index):
    return torch.gather(x, 1, tensor_like(index, x).long())


@op
def masked_select(x, mask):
    return torch.masked_select(x, tensor_like(mask, x).bool())


@op
def masked_fill(x, mask, value):
    return x.masked_fill(tensor_like(mask, x).bool(), value)


@op
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):  # noqa: A002
    """``pad`` holds (before, after) pairs in axis order: one per axis of
    ``x``, or one per trailing axis (the reference's reading; torch's own
    lists run innermost first)."""
    p = [int(v) for v in pad]
    pairs = [p[2 * i:2 * i + 2] for i in range(len(p) // 2)]
    p = [v for pr in reversed(pairs) for v in pr]
    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "replicate", "circular": "circular"}[mode]
    if tmode == "constant":
        return torch.nn.functional.pad(x, p, mode="constant", value=value)
    return torch.nn.functional.pad(x, p, mode=tmode)


@op
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """numpy's unique (sorted), on the host: its size is the data's."""
    arr = host_array(x)
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(torch.as_tensor(np.asarray(r), device=x.device)
                     for r in res)
    return torch.as_tensor(res, device=x.device)


def assign(x, output=None):
    """A copy of ``x`` (differentiable), or ``x`` written into
    ``output`` in place."""
    if output is None:
        return _assign_copy(x)
    output.set_value(x)
    return output


@op
def _assign_copy(x):
    return tensor_like(x, None).clone()


@op
def numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@op
def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


@op
def meshgrid(*xs):
    if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
        xs = xs[0]
    return list(torch.meshgrid(*xs, indexing="ij"))


@op
def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


@op
def one_hot(x, num_classes):
    return torch.nn.functional.one_hot(x.long(), num_classes).float()


def _index(idx):
    """An index for torch: lists and arrays as tensors, nested."""
    if isinstance(idx, tuple):
        return tuple(_index(i) for i in idx)
    if isinstance(idx, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(idx))
    return idx


@op
def getitem(x, idx):
    """``x[idx]`` with numpy's basic and advanced indexing, differentiable;
    basic indices give a view."""
    return x[_index(idx)]


def setitem(x, idx, value):
    """``x[idx] = value`` in place (recorded by autograd on a tensor that
    is not a leaf)."""
    idx = _index(unwrap(idx))
    value = unwrap(value)
    if not isinstance(value, torch.Tensor):
        value = tensor_like(value, unwrap(x))
    with torch._C.DisableTorchFunctionSubclass():
        torch.Tensor.__setitem__(x, idx, value.to(x.dtype))
    return x
