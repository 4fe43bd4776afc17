"""TDM retrieval ops (counterpart: ``paddle_tpu/ops/tdm.py``; the reference
framework's `operators/tdm_sampler_op.{cc,h}` and `operators/
tdm_child_op.{cc,h}`, behind `fluid.contrib.layers.tdm_sampler/tdm_child`).

Host numpy ops, as in the reference: they run in the input pipeline and
emit fixed-shape id tensors for the tower step on the device. Their
results are tensors on the input ``x``'s device (host data goes to the
card unless it is a CPU tensor). ``dtype="int64"`` gives ``torch.int64``;
the reference gives int32 unless JAX's x64 mode is on. ``tdm_sampler``
keeps the reference's loop and draw order (one ``RandomState(seed)``, a
resample on collision); ``tdm_child`` is one gather over the whole input.
"""
import numpy as np
import torch

from ..core.device import resolve_device
from ..core.tensor import host_array, unwrap, wrap

__all__ = ["tdm_sampler", "tdm_child"]


def _host(v):
    v = unwrap(v)
    if isinstance(v, torch.Tensor):
        return host_array(v)
    return np.asarray(v)


def _device_of(x):
    x = unwrap(x)
    return x.device if isinstance(x, torch.Tensor) else resolve_device(None)


def _ids(arr, dtype, device):
    """``arr`` as an id tensor of ``dtype`` on ``device``; int32 ids that
    do not fit raise instead of wrapping."""
    if dtype not in ("int64", "int32"):
        raise ValueError(f"tdm ids are int64 or int32, not {dtype!r}")
    if dtype == "int32" and arr.size and (
            int(arr.max()) > np.iinfo(np.int32).max):
        raise ValueError("tdm ids exceed int32 range; use dtype='int64'")
    return wrap(torch.from_numpy(arr.astype(dtype)).to(device))


def tdm_sampler(x, neg_samples_num_list, layer_node_num_list, travel,
                layer, layer_offsets=None, output_positive=True, seed=0,
                dtype="int64"):
    """Layer-wise negative sampling over a TDM tree
    (tdm_sampler_op.h:49 TDMSamplerInner).

    ``x``: (batch, 1) or (batch,) leaf ITEM ids.
    ``travel``: (n_items, n_layers) per-item ancestor emb ids, root-side
    first, 0-padded (TreeIndex.travel_array).
    ``layer``/``layer_offsets``: flattened per-layer emb ids + offsets
    (TreeIndex.layer_array); ``layer_node_num_list`` must match the
    per-layer counts, like the reference validates.

    Returns (out, labels, mask), each
    (batch, sum(neg_i + output_positive)): positives carry label 1,
    uniform negatives (resampled on collision, reference's do/while)
    label 0; mask 0 marks padding rows from trees where this item's
    path is shorter.
    """
    device = _device_of(x)
    x_np = _host(x).astype(np.int64).ravel()
    travel = np.asarray(_host(travel), np.int64)
    layer_flat = np.asarray(_host(layer), np.int64).ravel()
    if layer_offsets is None:
        offsets = np.cumsum([0] + list(layer_node_num_list))
    else:
        offsets = np.asarray(_host(layer_offsets)).astype(np.int64)
    n_layers = len(neg_samples_num_list)
    if travel.shape[1] != n_layers or len(offsets) != n_layers + 1:
        raise ValueError(
            f"neg_samples_num_list ({n_layers} layers) must match "
            f"travel width {travel.shape[1]} and layer offsets "
            f"{len(offsets) - 1}")
    for li, want in enumerate(layer_node_num_list):
        have = int(offsets[li + 1] - offsets[li])
        if have != int(want):
            raise ValueError(
                f"layer_node_num_list[{li}]={want} but layer data has "
                f"{have} nodes")
        if int(neg_samples_num_list[li]) > have - 1:
            raise ValueError(
                f"neg_samples_num_list[{li}]={neg_samples_num_list[li]} "
                f"exceeds layer size {have} - 1")
    bad = np.flatnonzero((x_np < 0) | (x_np >= travel.shape[0]))
    if bad.size:
        raise ValueError(
            f"tdm_sampler input id {x_np[bad[0]]} outside travel table "
            f"[0, {travel.shape[0]})")
    pos = 1 if output_positive else 0
    negs = [int(n) for n in neg_samples_num_list]
    per_layer = [n + pos for n in negs]
    width = int(sum(per_layer))
    batch = x_np.size
    out = np.zeros((batch, width), np.int64)
    labels = np.zeros((batch, width), np.int64)
    mask = np.ones((batch, width), np.int64)
    layers = [layer_flat[offsets[li]:offsets[li + 1]]
              for li in range(n_layers)]
    sizes = [int(a.size) for a in layers]
    randint = np.random.RandomState(seed).randint
    paths = travel[x_np].tolist()
    for i in range(batch):
        path = paths[i]
        row = out[i]
        col = 0
        for li in range(n_layers):
            positive = path[li]
            if positive == 0:  # padded path: emit masked zeros
                w = per_layer[li]
                mask[i, col:col + w] = 0
                col += w
                continue
            if output_positive:
                row[col] = positive
                labels[i, col] = 1
                col += 1
            ids, size = layers[li], sizes[li]
            for _ in range(negs[li]):
                neg = positive
                while neg == positive:
                    neg = ids[randint(size)]
                row[col] = neg
                col += 1
    return (_ids(out, dtype, device), _ids(labels, dtype, device),
            _ids(mask, dtype, device))


def tdm_child(x, tree_info, child_nums, dtype="int64"):
    """Children lookup over a TDM tree (tdm_child_op.h:34 TDMChildInner).

    ``x``: node EMB ids, any shape. ``tree_info``: (n_emb_ids, 3+branch)
    rows of [item_id, layer, parent, child ids...] 0-padded
    (TreeIndex.tree_info_array). Returns (child, leaf_mask) shaped
    ``x.shape + (child_nums,)``: absent children are 0; leaf_mask is 1
    where the child exists AND is a leaf (item_id != 0), matching the
    reference's leaf-flag output.
    """
    device = _device_of(x)
    x_np = _host(x).astype(np.int64)
    info = np.asarray(_host(tree_info), np.int64)
    branch = info.shape[1] - 3
    if child_nums > branch:
        raise ValueError(
            f"child_nums {child_nums} exceeds tree branch {branch}")
    flat = x_np.ravel()
    bad = np.flatnonzero((flat < 0) | (flat >= info.shape[0]))
    if bad.size:
        raise ValueError(
            f"tdm_child input id {flat[bad[0]]} outside tree_info "
            f"[0, {info.shape[0]})")
    child = info[flat, 3:3 + child_nums]
    leaf_mask = ((child != 0) & (info[child, 0] != 0)).astype(np.int64)
    shape = x_np.shape + (child_nums,)
    return (_ids(child.reshape(shape), dtype, device),
            _ids(leaf_mask.reshape(shape), dtype, device))
