"""Residual dense-op tail (counterpart: ``paddle_tpu/ops/misc_tail.py``):
segmentation and sequence metrics, linear-algebra composites, sharding
helpers and vision IO.

References: `operators/mean_iou_op.{cc,h}`, `operators/chunk_eval_op.{cc,h}`,
`operators/diag_embed_op.cc`, `operators/bilinear_tensor_product_op.{cc,h}`,
`operators/shard_index_op.cc`, `operators/sampling_id_op.cc`,
`operators/match_matrix_tensor_op.{cc,h}` and `python/paddle/vision/ops.py`
read_file/decode_jpeg.

The device ops are torch operations on their inputs' device
(``math.op``), differentiable where the reference's are. The host ops stay
on the host in numpy, as in the reference: ``chunk_eval``,
``positive_negative_pair`` and ``similarity_focus`` (their work is the
data's structure) return on their input's device; ``read_file`` returns
the file's bytes on the CPU, and ``decode_jpeg`` decodes with PIL, as the
reference does, and returns on its input's device: where PIL is not
installed it raises ``ImportError`` naming PIL. ``sampling_id`` draws its
uniforms from the package's generator on the input's device
(``core.random``), or from a generator seeded with ``seed``; threefry and
Philox never give the same draws, so its parity tests hand both packages
the same uniforms (:func:`_sample_ids`).
"""
import numpy as np
import torch

from ..core.device import resolve_device
from ..core.tensor import boundary, host_array, unwrap, wrap
from .math import op, tensor_like

__all__ = ["mean_iou", "chunk_eval", "diag_embed",
           "bilinear_tensor_product", "shard_index", "sampling_id",
           "read_file", "decode_jpeg", "match_matrix_tensor",
           "add_position_encoding", "batch_fc", "polygon_box_transform",
           "correlation", "sequence_topk_avg_pooling",
           "positive_negative_pair", "similarity_focus"]


def _t(x, like=None):
    return tensor_like(unwrap(x), like)


def _device_of(x):
    x = unwrap(x)
    return x.device if isinstance(x, torch.Tensor) else resolve_device(None)


def _host(x):
    x = unwrap(x)
    return host_array(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _scalar(v, dtype, device):
    return wrap(torch.tensor(v, dtype=dtype, device=device))


@op
def mean_iou(input, label, num_classes):  # noqa: A002
    """Mean intersection-over-union (mean_iou_op.h): per-class correct
    and wrong counts from the prediction and label, IoU averaged over the
    classes that appear. Returns (mean_iou, out_wrong, out_correct)."""
    pred = _t(input).reshape(-1).long()
    lab = _t(label, pred).reshape(-1).long()
    hit = pred == lab
    miss = (~hit).to(torch.int32)
    correct = torch.zeros(num_classes, dtype=torch.int32,
                          device=pred.device).index_add_(
        0, lab, hit.to(torch.int32))
    wrong = torch.zeros(num_classes, dtype=torch.int32, device=pred.device)
    wrong = wrong.index_add_(0, pred, miss).index_add_(0, lab, miss)
    denom = correct + wrong
    valid = denom > 0
    iou = torch.where(valid, correct / torch.clamp(denom, min=1),
                      torch.zeros((), device=pred.device))
    miou = torch.sum(iou) / torch.clamp(torch.sum(valid), min=1)
    return miou.to(torch.float32), wrong, correct


def _extract_chunks(tags, scheme, num_chunk_types, excluded):
    """Chunk segments as {(begin, end, type)} (chunk_eval_op.h
    ChunkEvalKernel::GetSegments). label = chunk_type * tags_per_type +
    tag_position, as in the reference."""
    chunks = set()
    n = len(tags)
    if scheme == "plain":
        i = 0
        while i < n:
            t = tags[i]
            if 0 <= t < num_chunk_types:
                j = i
                while j + 1 < n and tags[j + 1] == t:
                    j += 1
                chunks.add((i, j, int(t)))
                i = j + 1
            else:
                i += 1
    elif scheme in ("IOB", "IOE"):
        # IOB: type*2 = B, type*2+1 = I;  IOE: type*2 = I, type*2+1 = E
        i = 0
        while i < n:
            t = tags[i]
            ctype, pos = divmod(int(t), 2)
            if not 0 <= ctype < num_chunk_types:
                i += 1
                continue
            j = i
            if scheme == "IOB":
                # a chunk starts at B (or a stray I, the reference's
                # lenient begin) and runs through same-type I
                while j + 1 < n and tags[j + 1] == ctype * 2 + 1:
                    j += 1
            else:  # IOE: runs through same-type I, ends at E
                while j + 1 < n and tags[j] == ctype * 2 and \
                        tags[j + 1] in (ctype * 2, ctype * 2 + 1):
                    j += 1
            chunks.add((i, j, ctype))
            i = j + 1
    elif scheme == "IOBES":
        i = 0
        while i < n:
            t = tags[i]
            ctype, pos = divmod(int(t), 4)  # B, I, E, S
            if not 0 <= ctype < num_chunk_types:
                i += 1
                continue
            if pos == 3:  # S: a singleton
                chunks.add((i, i, ctype))
                i += 1
                continue
            j = i
            while j + 1 < n and tags[j + 1] in (ctype * 4 + 1,
                                                ctype * 4 + 2):
                end_pos = tags[j + 1] % 4
                j += 1
                if end_pos == 2:  # E closes the chunk
                    break
            chunks.add((i, j, ctype))
            i = j + 1
    else:
        raise ValueError(f"unknown chunk_scheme {scheme!r} "
                         f"(IOB, IOE, IOBES, plain)")
    if excluded:
        chunks = {c for c in chunks if c[2] not in excluded}
    return chunks


def chunk_eval(input, label, chunk_scheme, num_chunk_types,  # noqa: A002
               excluded_chunk_types=None, seq_length=None):
    """Chunk detection precision, recall and F1 (chunk_eval_op.cc, the NER
    metric), on the host like the reference's CPU-only kernel. Returns
    (precision, recall, f1, num_infer_chunks, num_label_chunks,
    num_correct_chunks) on ``input``'s device."""
    dev = _device_of(input)
    inp = _host(input).astype(np.int64)
    lab = _host(label).astype(np.int64)
    if inp.ndim == 1:
        inp, lab = inp[None, :], lab[None, :]
    excluded = set(excluded_chunk_types or [])
    lengths = (_host(seq_length).astype(np.int64).ravel()
               if seq_length is not None
               else np.full(inp.shape[0], inp.shape[1], np.int64))
    n_infer = n_label = n_correct = 0
    for b in range(inp.shape[0]):
        L = int(lengths[b])
        infer = _extract_chunks(inp[b, :L].tolist(), chunk_scheme,
                                num_chunk_types, excluded)
        gold = _extract_chunks(lab[b, :L].tolist(), chunk_scheme,
                               num_chunk_types, excluded)
        n_infer += len(infer)
        n_label += len(gold)
        n_correct += len(infer & gold)
    precision = n_correct / n_infer if n_infer else 0.0
    recall = n_correct / n_label if n_label else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    f32, i32 = torch.float32, torch.int32
    return (_scalar(precision, f32, dev), _scalar(recall, f32, dev),
            _scalar(f1, f32, dev), _scalar(n_infer, i32, dev),
            _scalar(n_label, i32, dev), _scalar(n_correct, i32, dev))


@op
def diag_embed(input, offset=0, dim1=-2, dim2=-1):  # noqa: A002
    """The last dim as the diagonal at ``offset`` of new square matrices
    over (``dim1``, ``dim2``) (diag_embed_op.cc)."""
    x = _t(input)
    n = x.shape[-1]
    m = n + abs(offset)
    rows = torch.arange(n, device=x.device) + max(-offset, 0)
    cols = torch.arange(n, device=x.device) + max(offset, 0)
    out = x.new_zeros(x.shape[:-1] + (m, m))
    out[..., rows, cols] = x
    nd = out.dim()
    d1 = dim1 if dim1 >= 0 else nd + dim1
    d2 = dim2 if dim2 >= 0 else nd + dim2
    return torch.movedim(out, (nd - 2, nd - 1), (d1, d2))


@op
def bilinear_tensor_product(x, y, weight, bias=None):
    """out[b, k] = x[b]ᵀ W[k] y[b] (+ bias)
    (bilinear_tensor_product_op.h), one einsum."""
    out = torch.einsum("bi,kij,bj->bk", _t(x), _t(weight), _t(y))
    return out if bias is None else out + _t(bias)


@op
def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    """Global ids onto one shard's local range (shard_index_op.cc): ids
    owned by ``shard_id`` become ``id % shard_size``, others
    ``ignore_value``."""
    if not 0 <= shard_id < nshards:
        raise ValueError(f"shard_id {shard_id} outside [0, {nshards})")
    ids = _t(input)
    shard_size = (index_num + nshards - 1) // nshards
    return torch.where(ids // shard_size == shard_id, ids % shard_size,
                       torch.full_like(ids, ignore_value))


def _sample_ids(x, u):
    """The column index of each row of ``x`` that uniform ``u[row]``
    falls in: the first ``j`` with ``cumsum(x[row])[j] > u[row]``, at most
    the last column."""
    cs = torch.cumsum(x, dim=1)
    idx = torch.sum((cs <= u[:, None]).to(torch.int64), dim=1)
    return torch.clamp(idx, max=x.shape[1] - 1)


def sampling_id(x, min=0.0, max=1.0, seed=0):  # noqa: A002
    """One column index per row of a probability matrix
    (sampling_id_op.cc): u ~ U(min, max), index = the first j with
    cumsum(x[i])[j] > u. With ``seed`` the draws repeat; ``seed=0`` draws
    from the package's generator."""
    from ..core import random as core_random
    xv = _t(x)
    if seed:
        gen = torch.Generator(device=xv.device)
        gen.manual_seed(int(seed))
    else:
        gen = core_random.draw_generator(xv.device)
    with torch.no_grad():
        u = torch.rand(xv.shape[0], generator=gen, device=xv.device,
                       dtype=torch.float32) * (max - min) + min
        return wrap(_sample_ids(xv.detach(), u))


def read_file(filename, name=None):
    """The file's bytes as a uint8 tensor on the CPU (vision/ops.py
    read_file: host data for ``decode_jpeg``)."""
    with open(filename, "rb") as f:
        data = f.read()
    return wrap(torch.from_numpy(np.frombuffer(data, np.uint8).copy()))


def decode_jpeg(x, mode="unchanged", name=None):
    """A JPEG byte tensor decoded to CHW uint8 on its device (vision/ops.py
    decode_jpeg), with PIL on the host as in the reference."""
    import io
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decode_jpeg decodes on the host with PIL (Pillow), which is "
            "not installed") from e
    dev = _device_of(x)
    raw = bytes(_host(x).astype(np.uint8))
    img = Image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    arr = arr[None, :, :] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return wrap(torch.from_numpy(np.ascontiguousarray(arr)).to(dev))


def match_matrix_tensor(x, y, w, x_lens=None, y_lens=None):
    """The semantic-match tensor (match_matrix_tensor_op.h) in the padded
    form: x (B, Lx, Dx), y (B, Ly, Dy), w (Dx, T, Dy) -> (out (B, T, Lx,
    Ly), mask (B, 1, Lx, Ly)), the mask zero at padded positions."""
    out = _mmt(x, y, w)
    xv, yv = unwrap(out), _t(y)
    b, lx, ly = xv.shape[0], xv.shape[2], yv.shape[1]
    dev = xv.device
    if x_lens is None and y_lens is None:
        return out, wrap(torch.ones((b, 1, lx, ly), dtype=torch.float32,
                                    device=dev))
    xl = (_t(x_lens, xv).reshape(b, 1) if x_lens is not None
          else torch.full((b, 1), lx, device=dev))
    yl = (_t(y_lens, xv).reshape(b, 1) if y_lens is not None
          else torch.full((b, 1), ly, device=dev))
    mx = (torch.arange(lx, device=dev)[None, :] < xl).to(torch.float32)
    my = (torch.arange(ly, device=dev)[None, :] < yl).to(torch.float32)
    return out, wrap((mx[:, :, None] * my[:, None, :])[:, None, :, :])


def _mmt_body(x, y, w):
    return torch.einsum("bid,dtm,bjm->btij", _t(x), _t(w), _t(y))


_mmt = boundary(_mmt_body, always=True, op_name="match_matrix_tensor")


@op
def add_position_encoding(x, alpha=1.0, beta=1.0):
    """out = alpha·x + beta·PE (add_position_encoding_op.h): the first half
    of the features sin(pos / 10000^(i/half)), the second half cos."""
    xv = _t(x)
    B, L, D = xv.shape
    if D % 2:
        raise ValueError("feature size must be even")
    half = D // 2
    pos = torch.arange(L, dtype=torch.float32, device=xv.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, device=xv.device),
                    torch.arange(half, dtype=torch.float32,
                                 device=xv.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return alpha * xv + beta * pe[None, :, :]


@op
def batch_fc(input, w, bias=None):  # noqa: A002
    """Per-slot batched FC (batch_fc_op.cc): input (S, B, I) @ w (S, I, O)
    + bias (S, 1, O), one batched matmul."""
    out = torch.einsum("sbi,sio->sbo", _t(input), _t(w))
    return out if bias is None else out + _t(bias)


@op
def polygon_box_transform(input):  # noqa: A002
    """EAST geometry-map decode (polygon_box_transform_op.cc): even
    channels become 4·x_index − v, odd channels 4·y_index − v."""
    xv = _t(input)
    B, G, H, W = xv.shape
    xs = torch.arange(W, dtype=xv.dtype, device=xv.device)[
        None, None, None, :] * 4.0
    ys = torch.arange(H, dtype=xv.dtype, device=xv.device)[
        None, None, :, None] * 4.0
    even = torch.arange(G, device=xv.device) % 2 == 0
    return torch.where(even[None, :, None, None], xs, ys) - xv


@op
def correlation(x1, x2, pad_size, kernel_size, max_displacement,
                stride1=1, stride2=1):
    """FlowNet's correlation volume (correlation_op.cc): the channel mean
    of x1 · shift(x2, d) for every displacement d of the
    (2·max_displacement/stride2 + 1)² window."""
    if kernel_size != 1:
        raise NotImplementedError(
            "correlation with kernel_size != 1 (the common FlowNet "
            "config) is not implemented")
    a, b = _t(x1), _t(x2)
    d = max_displacement // stride2
    C, H, W = a.shape[1], a.shape[2], a.shape[3]
    hs = torch.arange(H, device=a.device)
    ws = torch.arange(W, device=a.device)
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            sy, sx = dy * stride2, dx * stride2
            shifted = torch.roll(b, (sy, sx), dims=(2, 3))
            m = ((hs >= sy) & (hs < H + sy))[:, None] & \
                ((ws >= sx) & (ws < W + sx))[None, :]
            outs.append(torch.sum(a * shifted * m[None, None], dim=1) / C)
    out = torch.stack(outs, dim=1)
    if stride1 > 1:
        out = out[:, :, ::stride1, ::stride1]
    return out


@op
def sequence_topk_avg_pooling(x, lengths, topks, channel_num=1):
    """Top-k average pooling over the sequence axis
    (sequence_topk_avg_pooling_op.cc) in the padded form: x (B, C, L) with
    per-sample ``lengths``; for each k of ``topks`` the mean of the top-k
    in-length scores. Returns (B, C, len(topks))."""
    xv = _t(x)
    lens = _t(lengths, xv)
    topks = list(topks)
    kmax = max(topks)
    L = xv.shape[-1]
    mask = torch.arange(L, device=xv.device)[None, None, :] < \
        lens[:, None, None]
    vals = torch.where(mask, xv, torch.tensor(-3.4e38, dtype=xv.dtype,
                                              device=xv.device))
    top = torch.topk(vals, kmax, dim=-1).values
    outs = []
    for k in topks:
        valid = torch.clamp(lens, max=k)[:, None].to(xv.dtype)
        picked = torch.where(torch.arange(kmax, device=xv.device)[
            None, None, :] < valid[:, :, None], top,
            torch.zeros((), dtype=xv.dtype, device=xv.device))
        outs.append(torch.sum(picked, dim=-1) / torch.clamp(valid, min=1.0))
    return torch.stack(outs, dim=-1)


def positive_negative_pair(score, label, query_id):
    """The ranking-pair metric (positive_negative_pair_op.cc): within each
    query, ordered pairs where the higher-labeled item out-scores the
    lower one (pos), the reverse (neg), and ties (neu), on the host.
    Returns (positive, negative, neutral) float32 scalars on ``score``'s
    device."""
    dev = _device_of(score)
    s = _host(score).astype(np.float64).ravel()
    lab = _host(label).astype(np.float64).ravel()
    q = _host(query_id).ravel()
    pos = neg = neu = 0.0
    for qid in np.unique(q):
        idx = np.nonzero(q == qid)[0]
        for a in range(idx.size):
            for b in range(a + 1, idx.size):
                i, j = idx[a], idx[b]
                if lab[i] == lab[j]:
                    continue
                hi, lo = (i, j) if lab[i] > lab[j] else (j, i)
                if s[hi] > s[lo]:
                    pos += 1
                elif s[hi] < s[lo]:
                    neg += 1
                else:
                    neu += 1
    f32 = torch.float32
    return (_scalar(pos, f32, dev), _scalar(neg, f32, dev),
            _scalar(neu, f32, dev))


def similarity_focus(x, axis, indexes):
    """The similarity-focus mask (similarity_focus_op.h): for each selected
    slice along ``axis``, greedily pick maxima whose two free coordinates
    are both unused and set the mask to 1 along the whole ``axis`` fiber
    there (a greedy bipartite matching over the slice). On the host, like
    the reference's CPU-only kernel; x: 4-D (N, d1, d2, d3), axis 1-3."""
    dev = _device_of(x)
    xv = _host(x).astype(np.float32)
    if xv.ndim != 4:
        raise ValueError("similarity_focus expects a 4-D input")
    if axis not in (1, 2, 3):
        raise ValueError("axis must be 1, 2 or 3")
    if not indexes:
        raise ValueError("indexes must be non-empty")
    if min(indexes) < 0 or max(indexes) >= xv.shape[axis]:
        raise ValueError(
            f"indexes {list(indexes)} out of range for axis {axis} "
            f"(size {xv.shape[axis]}; negatives rejected like the "
            f"reference op)")
    free = [a for a in (1, 2, 3) if a != axis]
    out = np.zeros_like(xv)
    for b in range(xv.shape[0]):
        for index in indexes:
            sl = np.take(xv[b], index, axis=axis - 1)  # (dA, dB)
            dA, dB = sl.shape
            order = np.argsort(-sl.ravel(), kind="stable")
            usedA = np.zeros(dA, bool)
            usedB = np.zeros(dB, bool)
            picked = 0
            for flat in order:
                ia, ib = divmod(int(flat), dB)
                if usedA[ia] or usedB[ib]:
                    continue
                usedA[ia] = usedB[ib] = True
                sel = [b, None, None, None]
                sel[free[0]] = ia
                sel[free[1]] = ib
                sel[axis] = slice(None)
                out[tuple(sel)] = 1.0
                picked += 1
                if picked == min(dA, dB):
                    break
    return wrap(torch.from_numpy(out).to(dev))
