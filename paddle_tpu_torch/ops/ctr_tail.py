"""CTR, text-matching and tree op tail (counterpart:
``paddle_tpu/ops/ctr_tail.py``; the reference framework's pslib-era
contrib set `python/paddle/fluid/contrib/layers/nn.py` — shuffle_batch:785,
filter_by_instag, search_pyramid_hash:669, rank_attention:1321,
tree_conv:402, var_conv_2d:129 — with kernels in `operators/{shuffle_batch,
filter_by_instag,pyramid_hash,rank_attention,tree_conv,var_conv_2d}_op.*`).

``rank_attention``, ``var_conv_2d``, ``bilateral_slice``, ``shuffle_batch``
and the gather and sum of ``tree_conv`` and ``search_pyramid_hash`` are
torch ops on the inputs' device, differentiable as in the reference.
``filter_by_instag``, ``tree_conv``'s patches (``_tree_patches``) and the
pyramid's n-gram hashing (``_hash64``) run on the host in numpy, as in the
reference: their structure depends on the data. The hash is the
reference's bit for bit, computed over every n-gram of a window at once.
``shuffle_batch`` draws its permutation with torch's generator on the
input's device (``core.random.draw_generator``), so it is a different
permutation from the reference's for the same seed.
"""
import numpy as np
import torch

from ..core.dispatch import call_op
from ..core.tensor import host_array, unwrap, wrap

__all__ = ["shuffle_batch", "filter_by_instag", "search_pyramid_hash",
           "rank_attention", "tree_conv", "var_conv_2d",
           "bilateral_slice"]


def _host(v):
    v = unwrap(v)
    return host_array(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _permutation(n, device, seed):
    """A random permutation of ``n`` rows on ``device``: from a generator
    seeded with ``seed``, else from the package's generator."""
    from ..core import random as core_random
    if seed is None:
        gen = core_random.draw_generator(device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(_host(seed)))
    return torch.randperm(n, generator=gen, device=device)


def shuffle_batch(x, seed=None, startup_seed=0):
    """Random row permutation (reference: shuffle_batch_op.cc; returns the
    shuffled tensor like the python front-end, ShuffleIdx retrievable via
    return_index)."""
    xt = unwrap(x)
    perm = _permutation(xt.shape[0], xt.device, seed)
    return call_op(lambda v: v.index_select(0, perm), x,
                   op_name="shuffle_batch")


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    """Keep rows of `ins` whose tag set intersects `filter_tag`
    (reference: filter_by_instag_op.cc). HOST op: the output row count is
    data-dependent. `ins_tag`: list-of-lists (ragged per-row tags) or a
    padded [N, T] array (0 = padding). Returns (out, loss_weight,
    index_map) exactly like the reference outputs Out/LossWeight/IndexMap,
    on ``ins``'s device."""
    ins_t = unwrap(ins)
    if not isinstance(ins_t, torch.Tensor):
        ins_t = torch.as_tensor(np.asarray(ins_t))
    dev = ins_t.device
    ftags = set(int(t) for t in _host(filter_tag).ravel())
    if isinstance(ins_tag, (torch.Tensor, np.ndarray)):
        rows_tags = [set(int(t) for t in row if int(t) != 0)
                     for row in _host(ins_tag)]
    else:
        rows_tags = [set(int(t) for t in row) for row in ins_tag]
    keep = [i for i, tags in enumerate(rows_tags) if tags & ftags]
    if keep:
        idx = torch.as_tensor(keep, dtype=torch.int64, device=dev)
        out = call_op(lambda v: v.index_select(0, idx), ins_t,
                      op_name="filter_by_instag")
        loss_weight = np.ones((len(keep), 1), np.float32)
        index_map = np.asarray([[i, i] for i in keep], np.int64)
    else:
        # reference: emit one zero row so downstream shapes stay valid
        out = wrap(torch.full((1,) + tuple(ins_t.shape[1:]),
                              out_val_if_empty, dtype=ins_t.dtype,
                              device=dev))
        loss_weight = np.zeros((1, 1), np.float32)
        index_map = np.zeros((1, 2), np.int64)
    return (out, wrap(torch.from_numpy(loss_weight).to(dev)),
            wrap(torch.from_numpy(index_map).to(dev)))


def _hash64(a, b):
    """Deterministic splitmix64-style mix (the reference hashes n-grams
    with xxhash — the family differs, the pyramid semantics don't), over
    uint64 scalars or arrays, wrapping mod 2**64."""
    with np.errstate(over="ignore"):
        x = (np.asarray(a, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.asarray(b, np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
        x ^= x >> np.uint64(30)
        x = x * np.uint64(0x94D049BB133111EB) & np.uint64(0xFFFFFFFFFFFFFFFF)
        x = x ^ (x >> np.uint64(31))
    return x[()] if x.ndim == 0 else x


def _pyramid_rows(ids, pieces, space_len, pyramid_layer, seed):
    """The host half of the pyramid: ``(idx [B, G, pieces] int32, mask
    [B, G, 1, 1] float32)``, the table rows of every n-gram of window
    2..``pyramid_layer`` of each example's nonzero tokens, in the
    reference's order (window, then start)."""
    B, T = ids.shape
    toks = np.zeros((B, T), np.uint64)
    lengths = (ids != 0).sum(axis=1)
    for b in range(B):
        row = ids[b][ids[b] != 0]
        toks[b, :row.size] = row.astype(np.uint64)
    per_window = []
    for w in range(2, pyramid_layer + 1):
        S = max(0, T - w + 1)
        sig = np.full((B, S), np.uint64(seed), np.uint64)
        for j in range(w):
            sig = _hash64(sig, toks[:, j:j + S])
        rows = (_hash64(sig[..., None], np.arange(pieces, dtype=np.uint64))
                % np.uint64(space_len)).astype(np.int32)
        valid = np.arange(S)[None, :] < (lengths[:, None] - w + 1)
        per_window.append((rows, valid))
    counts = sum(v.sum(axis=1) for _r, v in per_window) if per_window \
        else np.zeros(B, np.int64)
    max_g = max(1, int(np.max(counts, initial=0)))
    idx = np.zeros((B, max_g, pieces), np.int32)
    mask = np.zeros((B, max_g, 1, 1), np.float32)
    for b in range(B):
        got = [r[b][v[b]] for r, v in per_window]
        got = np.concatenate(got) if got else np.zeros((0, pieces), np.int32)
        idx[b, :got.shape[0]] = got
        mask[b, :got.shape[0]] = 1.0
    return idx, mask


def search_pyramid_hash(input, weight, num_emb, space_len, pyramid_layer=2,  # noqa: A002
                        rand_len=16, drop_out_percent=0.0, is_training=False,
                        seed=0):
    """PyramidHash text embedding (reference: pyramid_hash_op.cc /
    search_pyramid_hash:669): every n-gram of window size 2..pyramid_layer
    is hashed `num_emb // rand_len` times into the [space_len, rand_len]
    table; the concatenated pieces form the n-gram embedding and a
    sequence's embedding is their sum.

    input: int [B, T] padded token ids (0 = pad). Returns [B, num_emb] on
    ``weight``'s device, differentiable in ``weight``.
    """
    assert num_emb % rand_len == 0, "num_emb must divide by rand_len"
    ids = _host(input).astype(np.int64)
    B = ids.shape[0]
    idx, mask = _pyramid_rows(ids, num_emb // rand_len, space_len,
                              pyramid_layer, seed)
    dev = unwrap(weight).device
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)

    def _emb(w):
        # [B, G, pieces, rand_len] -> sum over grams, concat pieces
        g = w[idx_t] * mask_t.to(w.dtype)
        return g.sum(dim=1).reshape(B, num_emb)

    out = call_op(_emb, weight, op_name="pyramid_hash")
    if is_training and drop_out_percent > 0:
        from ..nn import functional as F
        out = F.dropout(out, p=drop_out_percent, training=True)
    return out


def rank_attention(input, rank_offset, rank_param, max_rank=3, max_size=0):  # noqa: A002
    """Rank attention (reference: rank_attention.cu.h expand kernels):
    rank_offset [N, 1+2K] int32 — col 0 is the instance's own rank
    (1-based, 0 invalid); cols (2k+1, 2k+2) are the k-th related
    instance's rank and its row in `input`. For every instance the K
    related feature rows multiply the param block selected by
    (own_rank, related_rank): out[i] = sum_k X[index_k] @ P[(own-1)*K +
    (rank_k - 1)], with P viewed as [K*K, d, out]."""
    d = unwrap(input).shape[1]
    out_col = unwrap(rank_param).shape[1]
    K = max_rank

    def _ra(x, ro, p):
        ro = ro.to(torch.int64)
        own = ro[:, 0] - 1                       # [N]
        rel_rank = ro[:, 1::2] - 1               # [N, K]
        rel_idx = ro[:, 2::2]                    # [N, K]
        valid = (own[:, None] >= 0) & (rel_rank >= 0)
        gathered = x[rel_idx.clamp(0, x.shape[0] - 1)]       # [N, K, d]
        gathered = torch.where(valid[..., None], gathered,
                               gathered.new_zeros(()))
        pb = p.reshape(K * K, d, out_col)
        block = (own[:, None] * K + rel_rank).clamp(0, K * K - 1)
        pg = pb[block]                           # [N, K, d, out]
        pg = torch.where(valid[..., None, None], pg, pg.new_zeros(()))
        return torch.einsum("nkd,nkdo->no", gathered, pg)

    return call_op(_ra, input, rank_offset, rank_param,
                   op_name="rank_attention")


def _tree_patches(edges, n_nodes, max_depth):
    """construct_tree + construct_patch (reference: math/tree2col.cc) —
    DFS patches with (eta_t, eta_l, eta_r) continuous-binary-tree
    coefficients. Host structure work; returns (patch_idx [N, P],
    coef [N, P, 3], pmask [N, P])."""
    tr = [[] for _ in range(n_nodes + 2)]
    for u, v in edges:
        if u != 0 and v != 0:
            tr[int(u)].append(int(v))
        else:
            break

    def eta(index, pclen, depth):
        et = (max_depth - depth) / max_depth
        el = (1.0 - et) * (0.5 if pclen == 1
                           else (index - 1.0) / (pclen - 1.0))
        er = (1.0 - et) * (1.0 - (0.5 if pclen == 1 else
                                  (index - 1.0) / (pclen - 1.0)))
        return et, el, er

    patches = []
    for root in range(1, n_nodes + 1):
        patch = [(root, 1, 1, 0)]
        stack = [(root, 1, 1, 0)]
        visited = {root}
        while stack:
            node, _, _, depth = stack[-1]
            end = True
            sz = len(tr[node])
            for i, v in enumerate(tr[node]):
                if v not in visited and depth + 1 < max_depth:
                    visited.add(v)
                    stack.append((v, i, sz, depth + 1))
                    patch.append((v, i + 1, sz, depth + 1))
                    end = False
            if end:
                stack.pop()
        patches.append(patch)
    P = max(len(p) for p in patches)
    idx = np.zeros((n_nodes, P), np.int32)
    coef = np.zeros((n_nodes, P, 3), np.float32)
    pm = np.zeros((n_nodes, P, 1), np.float32)
    for r, patch in enumerate(patches):
        for j, (node, index, pclen, depth) in enumerate(patch):
            idx[r, j] = node - 1
            coef[r, j] = eta(index, pclen, depth)
            pm[r, j] = 1.0
    return idx, coef, pm


def tree_conv(nodes_vector, edge_set, filter, max_depth=2):  # noqa: A002
    """Tree-based convolution (TBCNN, reference: tree_conv_op.cc +
    math/tree2col.*): nodes_vector [B, N, C], edge_set [B, E, 2] int32
    (1-based node ids, 0-padded), filter [C, 3, output_size, num_filters]
    -> [B, N, output_size, num_filters]. The patches are built on the
    host; the gather and the contraction run on the device,
    differentiable in ``nodes_vector`` and ``filter``."""
    edges_np = _host(edge_set).astype(np.int64)
    B, N, _C = unwrap(nodes_vector).shape
    idxs, coefs, masks = [], [], []
    for b in range(B):
        i, c, m = _tree_patches(edges_np[b], N, max_depth)
        idxs.append(i)
        coefs.append(c)
        masks.append(m)
    P = max(i.shape[1] for i in idxs)
    idx = np.zeros((B, N, P), np.int64)
    coef = np.zeros((B, N, P, 3), np.float32)
    pm = np.zeros((B, N, P, 1), np.float32)
    for b in range(B):
        p = idxs[b].shape[1]
        idx[b, :, :p] = idxs[b]
        coef[b, :, :p] = coefs[b]
        pm[b, :, :p] = masks[b]
    dev = unwrap(nodes_vector).device
    idx_t, coef_t, pm_t = (torch.from_numpy(a).to(dev)
                           for a in (idx, coef, pm))

    def _tc(nodes, w):
        # gath[b, n, p] = nodes[b, idx[b, n, p]]
        gath = nodes[torch.arange(B, device=dev)[:, None, None], idx_t]
        gath = gath * pm_t.to(nodes.dtype)      # [B, N, P, C]
        # out[b,n,o,f] = sum_{p,c,e} gath[b,n,p,c] c3[b,n,p,e] w[c,e,o,f]
        return torch.einsum("bnpc,bnpe,ceof->bnof", gath,
                            coef_t.to(nodes.dtype), w)

    return call_op(_tc, nodes_vector, filter, op_name="tree_conv")


def var_conv_2d(x, rows, cols, filter, input_channel=1, output_channel=1,  # noqa: A002
                stride=(1, 1), kernel_size=(3, 3)):
    """Variable-size 2D convolution (reference: var_conv_2d_op.cc — conv
    over per-sample (row, col) sized images carried in LoD). Padded
    design: x [B, Cin, Hmax, Wmax] with per-sample valid extents
    `rows`/`cols` [B]; invalid area is masked to zero before AND after the
    conv so padding never leaks into valid outputs."""
    from ..nn import functional as F

    rows_np = _host(rows).astype(np.int32)
    cols_np = _host(cols).astype(np.int32)
    _B, _Cin, H, W = unwrap(x).shape
    dev = unwrap(x).device
    rmask = (np.arange(H)[None, :] < rows_np[:, None])
    cmask = (np.arange(W)[None, :] < cols_np[:, None])
    mask = torch.from_numpy(rmask[:, None, :, None]
                            & cmask[:, None, None, :]).to(dev)

    def _mask_in(v):
        return torch.where(mask, v, v.new_zeros(()))

    xm = call_op(_mask_in, x, op_name="var_conv_mask")
    out = F.conv2d(xm, filter, stride=stride,
                   padding=(kernel_size[0] // 2, kernel_size[1] // 2))
    oh, ow = unwrap(out).shape[2], unwrap(out).shape[3]
    orows = np.minimum((rows_np + stride[0] - 1) // stride[0], oh)
    ocols = np.minimum((cols_np + stride[1] - 1) // stride[1], ow)
    ormask = (np.arange(oh)[None, :] < orows[:, None])
    ocmask = (np.arange(ow)[None, :] < ocols[:, None])
    omask = torch.from_numpy(ormask[:, None, :, None]
                             & ocmask[:, None, None, :]).to(dev)

    def _mask_out(v):
        return torch.where(omask, v, v.new_zeros(()))

    return call_op(_mask_out, out, op_name="var_conv_mask_out")


def bilateral_slice(x, guide, grid, has_offset=False):
    """HDRnet bilateral-grid slice-and-apply (reference:
    bilateral_slice_op.cu BilateralSliceCudaForwardKernel): per pixel,
    trilinearly sample affine coefficients from `grid` at
    (gx, gy, guide-value) and apply them to the input channels.

    x [N, Cin, H, W]; guide [N, H, W] in [0,1];
    grid [N, Cg, gd, gh, gw] with Cg = Cout*Cin (+Cout when has_offset).
    Returns [N, Cout, H, W], differentiable in x, guide and grid.
    """
    N, Cin, H, W = unwrap(x).shape
    Cg = unwrap(grid).shape[1]
    stride = Cin + (1 if has_offset else 0)
    if Cg % stride:
        raise ValueError(
            f"grid channels {Cg} must be a multiple of Cin+offset "
            f"({stride}); check has_offset against how the grid was built")
    Cout = Cg // stride

    def _bs(xv, gv, grv):
        dev = grv.device
        gd, gh, gw = grv.shape[2], grv.shape[3], grv.shape[4]
        xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) \
            * gw / W
        ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) \
            * gh / H
        gx = xs[None, None, :].expand(N, H, W)
        gy = ys[None, :, None].expand(N, H, W)
        gz = gv.to(torch.float32) * gd

        def tri(coords, size):
            f = torch.floor(coords - 0.5).to(torch.int64)
            idx0 = f.clamp(0, size - 1)
            idx1 = (f + 1).clamp(0, size - 1)
            w1 = torch.clamp(1.0 - torch.abs(f + 0.5 - coords), min=0.0)
            w2 = torch.clamp(1.0 - torch.abs(f + 1.5 - coords), min=0.0)
            return (idx0, w1), (idx1, w2)

        corners_x = tri(gx, gw)
        corners_y = tri(gy, gh)
        corners_z = tri(gz, gd)
        bidx = torch.arange(N, device=dev)[:, None, None]
        grl = grv.permute(0, 2, 3, 4, 1)        # [N, gd, gh, gw, Cg]
        coeff = 0.0
        for ix, wx in corners_x:
            for iy, wy in corners_y:
                for iz, wz in corners_z:
                    cell = grl[bidx, iz, iy, ix]             # [N,H,W,Cg]
                    coeff = coeff + cell * (wx * wy * wz)[..., None]
        coeff = torch.movedim(coeff, -1, 1)                  # [N,Cg,H,W]
        co = coeff.reshape(N, Cout, stride, H, W)
        out = torch.einsum("noshw,nshw->nohw", co[:, :, :Cin], xv)
        if has_offset:
            out = out + co[:, :, Cin]
        return out

    return call_op(_bs, x, guide, grid, op_name="bilateral_slice")
