"""Sequence (LoD) ops and the decoding tail (counterpart:
``paddle_tpu/ops/sequence.py``).

As in the reference, a LoD batch is padded and dense with a lengths
vector (:class:`RaggedBatch`), and the ``sequence_*`` ops take (data,
lengths) pairs. The ops whose output size is the data's
(``sequence_expand``, ``sequence_concat``, ``sequence_slice``,
``sequence_erase``, ``sequence_unpad``, ``sequence_mask`` without
``maxlen``, ``edit_distance``) read their inputs on the host, as the
reference's do; the rest are torch ops on the data's device. Each op takes
and returns ``Tensor``s (``ops.math.op``); :func:`gather_tree`'s body
(``gather_tree.__wrapped__``) is what ``nn.dynamic_decode`` calls on
plain tensors.
"""
import numpy as np
import torch

from ..amp.auto_cast import cast_inputs, downcast_dtype
from ..core.dtype import convert_dtype
from ..core.tensor import _as_torch, host_array, unwrap, wrap
from .math import op

__all__ = ["RaggedBatch", "sequence_mask", "sequence_pad", "sequence_unpad",
           "sequence_expand", "sequence_reverse", "sequence_softmax",
           "sequence_pool", "sequence_concat", "sequence_slice",
           "sequence_expand_as", "sequence_first_step", "sequence_last_step",
           "sequence_enumerate", "sequence_erase", "gather_tree",
           "edit_distance", "ctc_align", "row_conv", "sequence_conv",
           "sequence_reshape", "sequence_scatter", "im2sequence"]


class RaggedBatch:
    """A LoD batch: ``data`` ``[B, T, ...]`` padded, ``lengths`` ``[B]``
    int32, both ``Tensor``s (host data goes to ``device``: the card unless
    the caller asks for the CPU)."""

    def __init__(self, data, lengths, device=None):
        self.data = wrap(_as_torch(data, device=device))
        self.lengths = wrap(_as_torch(
            lengths if isinstance(lengths, torch.Tensor)
            else np.asarray(lengths, np.int32), device=self.data.device))

    @classmethod
    def from_list(cls, rows, pad_value=0.0, maxlen=None, device=None):
        """Host rows padded with ``pad_value`` to the longest (or
        ``maxlen``)."""
        rows = [np.asarray(r) for r in rows]
        lengths = np.asarray([len(r) for r in rows], np.int32)
        T = maxlen or (int(lengths.max()) if len(rows) else 0)
        tail = rows[0].shape[1:] if rows else ()
        out = np.full((len(rows), T) + tail, pad_value,
                      dtype=rows[0].dtype if rows else np.float32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r[:T]
        return cls(out, lengths, device=device)

    def to_list(self):
        d = host_array(self.data)
        ls = host_array(self.lengths)
        return [d[i, :ls[i]] for i in range(len(ls))]

    @property
    def shape(self):
        return self.data.shape


def _like(arr, like):
    return torch.as_tensor(arr, device=unwrap(like).device)


@op
def sequence_mask(x, maxlen=None, dtype="int64"):
    """Lengths ``[B]`` -> ``[B, maxlen]`` of ``t < length`` (``maxlen``
    the largest length when not given, read on the host)."""
    T = int(maxlen) if maxlen is not None else int(x.max().item())
    return (torch.arange(T, device=x.device)[None, :] < x[..., None]).to(
        convert_dtype(dtype))


def sequence_pad(x, pad_value=0.0, maxlen=None, name=None):
    """Ragged rows (a list, or a ``RaggedBatch``) -> (padded, lengths)."""
    if isinstance(x, RaggedBatch):
        return x.data, x.lengths
    rb = RaggedBatch.from_list(x, pad_value, maxlen)
    return rb.data, rb.lengths


def sequence_unpad(x, length, name=None):
    """(padded, lengths) -> the rows on the host."""
    return RaggedBatch(x, length).to_list()


@op
def sequence_expand(x, lengths, name=None):
    """Row i of ``x`` repeated ``lengths[i]`` times."""
    return x.repeat_interleave(lengths.to(x.device).long(), dim=0)


@op
def sequence_reverse(x, lengths=None, name=None):
    """Each row reversed within its length (the padding stays)."""
    if lengths is None:
        return x.flip(1)
    T = x.shape[1]
    idx = torch.arange(T, device=x.device)[None, :]
    lens = lengths.to(x.device).long()[:, None]
    src = torch.where(idx < lens, lens - 1 - idx, idx)
    return x.gather(1, src.reshape(src.shape + (1,) * (x.dim() - 2))
                    .expand(x.shape))


@op
def sequence_softmax(x, lengths, name=None):
    """Softmax over time within each length (zero past it)."""
    out_dtype = downcast_dtype("sequence_softmax", x)
    (x,) = cast_inputs("sequence_softmax", x)
    T = x.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :]
            < lengths.to(x.device)[:, None])
    neg = torch.where(mask, x, float("-inf"))
    e = torch.exp(neg - neg.amax(1, keepdim=True)) * mask
    out = e / e.sum(1, keepdim=True).clamp_min(1e-12)
    return out if out_dtype is None else out.to(out_dtype)


def sequence_concat(inputs, name=None):
    """Row i of the result is row i of every input, concatenated: a
    ``RaggedBatch``."""
    rbs = [x if isinstance(x, RaggedBatch) else RaggedBatch.from_list(x)
           for x in inputs]
    rows = [rb.to_list() for rb in rbs]
    merged = [np.concatenate([r[i] for r in rows], axis=0)
              for i in range(len(rows[0]))]
    return RaggedBatch.from_list(merged, device=rbs[0].data.device)


def sequence_slice(x, offset, length, name=None):
    """Row i's ``[offset[i], offset[i] + length[i])``: a ``RaggedBatch``
    padded to the longest slice."""
    rb = x if isinstance(x, RaggedBatch) else RaggedBatch.from_list(x)
    off = np.asarray(host_array(offset) if isinstance(offset, torch.Tensor)
                     else offset).reshape(-1)
    ln = np.asarray(host_array(length) if isinstance(length, torch.Tensor)
                    else length).reshape(-1)
    out = [r[int(o):int(o) + int(l)]
           for r, o, l in zip(rb.to_list(), off, ln)]
    return RaggedBatch.from_list(out, device=rb.data.device)


def sequence_expand_as(x, y, name=None):
    """Row i of ``x`` repeated to align with ``y``'s row lengths."""
    lengths = y.lengths if isinstance(y, RaggedBatch) else y
    return sequence_expand(x, lengths, name=name)


def sequence_first_step(x, lengths=None, name=None):
    if isinstance(x, RaggedBatch):
        x, lengths = x.data, x.lengths
    return sequence_pool(x, lengths, pool_type="first", name=name)


def sequence_last_step(x, lengths=None, name=None):
    if isinstance(x, RaggedBatch):
        x, lengths = x.data, x.lengths
    return sequence_pool(x, lengths, pool_type="last", name=name)


@op
def sequence_enumerate(x, win_size, pad_value=0, name=None):
    """Every ``win_size`` window of each row, ``pad_value`` past the
    row's end: ``[B, T] -> [B, T, win_size]``."""
    if isinstance(x, RaggedBatch):
        data, lens = unwrap(x.data), unwrap(x.lengths)
    else:
        data, lens = x, None
    T = data.shape[1]
    if lens is None:
        lens = torch.full((data.shape[0],), T, device=data.device)
    pos = (torch.arange(T, device=data.device)[:, None]
           + torch.arange(win_size, device=data.device)[None, :])
    valid = pos[None] < lens.to(data.device)[:, None, None]
    g = data[:, pos.clamp_max(T - 1)]
    return torch.where(valid, g, pad_value)


def sequence_erase(x, tokens, name=None):
    """Each row without the given token values: a ``RaggedBatch``."""
    rb = x if isinstance(x, RaggedBatch) else RaggedBatch.from_list(x)
    toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
    rows = [r[~np.isin(r, toks)] for r in rb.to_list()]
    return RaggedBatch.from_list(rows, device=rb.data.device)


def sequence_pool(x, lengths, pool_type="average", name=None):
    """Pool over time within each length: sum, average, sqrt (sum over
    sqrt(length)), max, first or last."""
    pool_type = pool_type.lower()
    return op(_pool_fn(pool_type))(x, lengths)


def _pool_fn(pool_type):
    def pool(v, lens):
        T = v.shape[1]
        lens = lens.to(v.device)
        tail = (1,) * (v.dim() - 2)
        mask = (torch.arange(T, device=v.device)[None, :]
                < lens[:, None]).reshape(v.shape[:2] + tail)
        cnt = lens.to(v.dtype).clamp_min(1).reshape((-1,) + tail)
        if pool_type == "sum":
            return torch.where(mask, v, 0).sum(1)
        if pool_type == "average":
            return torch.where(mask, v, 0).sum(1) / cnt
        if pool_type == "sqrt":
            return torch.where(mask, v, 0).sum(1) / cnt.sqrt()
        if pool_type == "max":
            return torch.where(mask, v, float("-inf")).amax(1)
        if pool_type == "first":
            return v[:, 0]
        if pool_type == "last":
            idx = (lens - 1).clamp_min(0).long().reshape((-1, 1) + tail)
            return v.gather(1, idx.expand((-1, 1) + v.shape[2:])).squeeze(1)
        raise ValueError(f"unknown pool_type {pool_type}")
    pool.__name__ = f"sequence_pool_{pool_type}"
    return pool


@op
def gather_tree(ids, parents):
    """The beams of ``[T, B, beam]`` step ids, re-threaded from the last
    step back through the parent pointers."""
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    parent = beam
    outs = []
    for t in range(ids.shape[0] - 1, -1, -1):
        outs.append(ids[t].gather(1, parent))
        parent = parents[t].gather(1, parent).long()
    outs.reverse()
    return torch.stack(outs)


def _levenshtein(a, b):
    prev = np.arange(len(b) + 1, dtype=np.float32)
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        for j in range(1, len(b) + 1):
            cost = 0.0 if a[i - 1] == b[j - 1] else 1.0
            cur[j] = min(prev[j] + 1.0, cur[j - 1] + 1.0, prev[j - 1] + cost)
        prev = cur
    return prev[len(b)]


def edit_distance(input, label, normalized=True, input_length=None,  # noqa: A002
                  label_length=None):
    """The Levenshtein distance of each row's first ``input_length``
    against its first ``label_length`` tokens (by the label's length when
    ``normalized``), ``[B, 1]`` float32, on the host; and the batch size
    (int32)."""
    a, b = host_array(input), host_array(label)
    la = (host_array(input_length) if input_length is not None
          else np.full(a.shape[0], a.shape[1]))
    lb = (host_array(label_length) if label_length is not None
          else np.full(b.shape[0], b.shape[1]))
    d = np.array([_levenshtein(a[i, :la[i]], b[i, :lb[i]])
                  for i in range(a.shape[0])], np.float32)
    if normalized:
        d = d / np.maximum(lb.astype(np.float32), np.float32(1.0))
    return (wrap(_like(d[:, None].astype(np.float32), input)),
            wrap(_like(np.int32(a.shape[0]), input)))


def ctc_align(input, input_length=None, blank=0, padding_value=0):  # noqa: A002
    """Repeats merged and blanks dropped within each length: (``[B, T]``
    aligned and padded with ``padding_value``, lengths ``[B]`` int32)."""
    x = unwrap(input)
    B, T = x.shape
    ln = (unwrap(input_length).to(x.device).long() if input_length is not None
          else torch.full((B,), T, device=x.device))
    valid = torch.arange(T, device=x.device)[None, :] < ln[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=x.dtype, device=x.device),
                      x[:, :-1]], dim=1)
    keep = (x != blank) & (x != prev) & valid
    slot = torch.where(keep, keep.long().cumsum(1) - 1, T)
    out = torch.full((B, T + 1), padding_value, dtype=x.dtype,
                     device=x.device)
    # each dropped token lands in the spare column T, cut below
    out.scatter_(1, torch.where(keep, slot, T), x)
    out[:, T] = padding_value
    return wrap(out[:, :T].contiguous()), wrap(keep.sum(1).to(torch.int32))


@op
def row_conv(input, weight):  # noqa: A002
    """Lookahead convolution: ``out[b, t] = sum_i x[b, t + i] * w[i]``
    over the future window (zeros past the end)."""
    input, weight = cast_inputs("row_conv", input, weight)
    k, T = weight.shape[0], input.shape[1]
    pad = torch.nn.functional.pad(input, (0, 0, 0, k - 1))
    out = pad[:, 0:T] * weight[0]
    for i in range(1, k):
        out = out + pad[:, i:i + T] * weight[i]
    return out


@op
def sequence_conv(x, filter, context_length, context_start=None,  # noqa: A002
                  lengths=None, padding_value=0.0):
    """Each step's window ``[t + context_start, t + context_start +
    context_length)`` (padding outside, and past each length) concatenated
    and projected by ``filter`` ``[context_length * D, out]``."""
    x, filter = cast_inputs("sequence_conv", x, filter)
    start = (-((context_length - 1) // 2) if context_start is None
             else context_start)
    B, T, D = x.shape
    pre = max(0, -start)
    post = max(0, start + context_length - 1)
    pad = torch.nn.functional.pad(x, (0, 0, pre, post), value=padding_value)
    if lengths is not None:
        pos = torch.arange(T + pre + post, device=x.device) - pre
        valid = (pos[None, :] >= 0) & (pos[None, :]
                                       < lengths.to(x.device)[:, None])
        pad = torch.where(valid[..., None], pad, padding_value)
    cols = torch.cat([pad[:, start + i + pre:start + i + pre + T]
                      for i in range(context_length)], dim=-1)
    return cols @ filter


@op
def sequence_reshape(x, new_dim):
    """``[B, T, D] -> [B, T * D / new_dim, new_dim]``."""
    B, T, D = x.shape
    return x.reshape(B, T * D // new_dim, new_dim)


@op
def sequence_scatter(x, index, updates):
    """``x`` ``[B, T]`` plus ``updates`` added at each row's ``index``
    ``[B, K]``."""
    return x.index_put((torch.arange(x.shape[0], device=x.device)[:, None],
                        index.to(x.device).long()), updates, accumulate=True)


@op
def im2sequence(x, filter_size, stride=1, padding=0):
    """Sliding-window patches of ``[N, C, H, W]``: ``[N * oh * ow, C * kh
    * kw]``, rows in output-position order, columns channel-major."""
    (x,) = cast_inputs("im2sequence", x)
    pair = (lambda v: (v, v) if isinstance(v, int) else tuple(v))
    cols = torch.nn.functional.unfold(x, pair(filter_size),
                                      padding=pair(padding),
                                      stride=pair(stride))
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])

