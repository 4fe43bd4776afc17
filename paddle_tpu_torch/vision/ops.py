"""Detection ops (counterpart: ``paddle_tpu/vision/ops.py``).

Each op runs where its inputs lie and returns its results there. The
dense ops (``yolov3_loss``, ``yolo_box``, ``box_coder``, ``iou_similarity``,
``box_clip``, ``anchor_generator``, ``prior_box``, ``density_prior_box``,
RoIAlign and its kin) are torch operations with gradients. The ops whose
output size depends on the data (the NMS family, ``generate_proposals``,
``distribute_fpn_proposals``, the target and metric ops) run on the host
in numpy, as the reference runs them: they read their device inputs back
once and return tensors on the inputs' device. None of these ops is a
hand-written kernel: none is a Pallas kernel in the reference.

Each docstring says whether the op can run inside a captured CUDA graph
(``jit.to_static`` or a serving engine on the card): the host ops cannot,
nor can an op that reads ``boxes_num`` on the host. Constant tensors (the
anchors, the anchor mask's look-up table) are built on the device once per
value and device, on the op's first eager call, never inside a capture.
"""
import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["yolo_box", "prior_box", "box_coder", "nms", "multiclass_nms",
           "roi_align", "distribute_fpn_proposals", "psroi_pool",
           "generate_proposals", "bipartite_match", "target_assign",
           "density_prior_box", "matrix_nms", "rpn_target_assign",
           "mine_hard_examples", "detection_map", "roi_pool", "yolov3_loss",
           "anchor_generator", "iou_similarity", "box_clip", "prroi_pool"]


# -- helpers -----------------------------------------------------------------

def _device(*xs):
    """The device of the first tensor among ``xs``, else the default
    (the card)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def _np(x, dtype=None):
    """A host numpy copy of ``x`` (a tensor, array or list)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def _out(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


_CONSTS = {}


def _const(key, device, build):
    """A constant tensor ``build(device)`` made once per ``key`` and device;
    raises if first asked for inside a CUDA graph capture (a host-to-device
    copy there breaks the graph)."""
    k = (key, str(device))
    t = _CONSTS.get(k)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"detection constant {key!r} was first needed inside a CUDA "
                "graph capture; call the op once eagerly first (a warm-up)")
        t = _CONSTS[k] = build(device)
    return t


def _anchor_consts(anchors, anchor_mask, device):
    """(anchors [an, 2] float32, the mask's anchors [mask, 2], the look-up
    table anchor -> mask index or -1 [an] int64), on ``device``."""
    anchors, anchor_mask = tuple(anchors), tuple(anchor_mask)
    an_num = len(anchors) // 2

    def build(dev):
        anc = torch.tensor(anchors, dtype=torch.float32,
                           device=dev).reshape(an_num, 2)
        lut = [-1] * an_num
        for mi, a in enumerate(anchor_mask):
            lut[a] = mi
        return (anc, anc[torch.tensor(anchor_mask, device=dev)],
                torch.tensor(lut, dtype=torch.int64, device=dev))

    return _const(("yolo_anchors", anchors, anchor_mask), device, build)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _rois_per_image(boxes_num, n_rois, device):
    """The image index of each RoI from ``boxes_num`` (read on the host)."""
    nums = _np(boxes_num).astype(np.int64)
    idx = np.repeat(np.arange(len(nums)), nums)[:n_rois]
    return torch.from_numpy(idx).to(device)


# -- dense ops ---------------------------------------------------------------

def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive RoI pooling: the channels are grouped as
    ``C = out_channels * ph * pw``; bin (i, j) of each RoI averages its
    region of channel group (c, i, j). Returns ``[R, C / (ph pw), ph, pw]``.
    Reads ``boxes_num`` on the host: not capturable."""
    ph, pw = _pair(output_size)
    N, C, H, W = (int(s) for s in x.shape)
    if C % (ph * pw) != 0:
        raise ValueError(f"psroi_pool needs channels {C} divisible by "
                         f"{ph}x{pw}")
    c_out = C // (ph * pw)
    R = int(boxes.shape[0])
    img = _rois_per_image(boxes_num, R, x.device)
    rois = boxes.float() * spatial_scale
    x1, y1, x2, y2 = rois[:, 0], rois[:, 1], rois[:, 2], rois[:, 3]
    rh = torch.clamp(y2 - y1, min=0.1) / ph  # tiny RoIs clamped
    rw = torch.clamp(x2 - x1, min=0.1) / pw
    xg = x[img].reshape(R, c_out, ph, pw, H, W)
    ys = torch.arange(H, dtype=torch.float32, device=x.device)
    xs = torch.arange(W, dtype=torch.float32, device=x.device)
    rows = []
    for i in range(ph):
        row = []
        for j in range(pw):
            hs = torch.clamp(torch.floor(y1 + i * rh), 0, H)
            he = torch.clamp(torch.ceil(y1 + (i + 1) * rh), 0, H)
            ws = torch.clamp(torch.floor(x1 + j * rw), 0, W)
            we = torch.clamp(torch.ceil(x1 + (j + 1) * rw), 0, W)
            mh = (ys[None, :] >= hs[:, None]) & (ys[None, :] < he[:, None])
            mw = (xs[None, :] >= ws[:, None]) & (xs[None, :] < we[:, None])
            m = mh[:, None, :, None] & mw[:, None, None, :]
            area = torch.clamp((he - hs) * (we - ws), min=1.0)
            s = torch.where(m, xg[:, :, i, j], 0.0).sum(dim=(2, 3))
            row.append(s / area[:, None])
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    """YOLOv3 box decode. ``x``: ``[N, an (5 + class_num), H, W]``;
    ``img_size``: ``[N, 2]`` (h, w). Returns boxes ``[N, H W an, 4]`` (xyxy,
    image scale) and scores ``[N, H W an, class_num]``, zero where the
    objectness is at most ``conf_thresh``. Capturable (after one eager
    call, which builds the anchors on the device)."""
    an = len(anchors) // 2
    anc = _anchor_consts(anchors, range(an), x.device)[0]
    N, _, H, W = x.shape
    xv = x.reshape(N, an, 5 + class_num, H, W)
    tx, ty, tw, th = xv[:, :, 0], xv[:, :, 1], xv[:, :, 2], xv[:, :, 3]
    tconf = xv[:, :, 4]
    tcls = xv[:, :, 5:]
    gx = torch.arange(W, dtype=torch.float32,
                      device=x.device)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32,
                      device=x.device)[None, None, :, None]
    bx = (torch.sigmoid(tx) * scale_x_y - 0.5 * (scale_x_y - 1.0) + gx) / W
    by = (torch.sigmoid(ty) * scale_x_y - 0.5 * (scale_x_y - 1.0) + gy) / H
    aw = anc[:, 0][None, :, None, None]
    ah = anc[:, 1][None, :, None, None]
    bw = torch.exp(tw) * aw / (downsample_ratio * W)
    bh = torch.exp(th) * ah / (downsample_ratio * H)
    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    x0 = (bx - bw / 2.0) * img_w
    y0 = (by - bh / 2.0) * img_h
    x1 = (bx + bw / 2.0) * img_w
    y1 = (by + bh / 2.0) * img_h
    if clip_bbox:
        zero = torch.zeros((), dtype=x0.dtype, device=x.device)
        x0 = torch.clamp(x0, zero, img_w - 1.0)
        y0 = torch.clamp(y0, zero, img_h - 1.0)
        x1 = torch.clamp(x1, zero, img_w - 1.0)
        y1 = torch.clamp(y1, zero, img_h - 1.0)
    conf = torch.sigmoid(tconf)
    mask = (conf > conf_thresh).float()
    scores = torch.sigmoid(tcls) * (conf * mask)[:, :, None]
    boxes = torch.stack([x0, y0, x1, y1], dim=-1) * mask[..., None]
    # [N, an, H, W, .] -> [N, H W an, .]
    boxes = boxes.permute(0, 2, 3, 1, 4).reshape(N, H * W * an, 4)
    scores = scores.permute(0, 3, 4, 1, 2).reshape(N, H * W * an, class_num)
    return boxes, scores


def _prior_aspects(aspect_ratios, flip):
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    return ars


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes for a feature map ``input`` ``[N, C, H, W]`` over an
    image ``[N, C, Hi, Wi]``: (boxes ``[H, W, P, 4]``, variances ``[H, W,
    P, 4]``), normalized xyxy. Computed on the host from the shapes, then
    put on ``input``'s device: not capturable."""
    H, W = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    ars = _prior_aspects(aspect_ratios, flip)
    step_w = steps[0] or img_w / W
    step_h = steps[1] or img_h / H
    widths, heights = [], []
    for ms in min_sizes:
        if min_max_aspect_ratios_order:
            widths.append(ms)
            heights.append(ms)
            if max_sizes:
                s = np.sqrt(ms * max_sizes[min_sizes.index(ms)])
                widths.append(s)
                heights.append(s)
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                widths.append(ms * np.sqrt(ar))
                heights.append(ms / np.sqrt(ar))
        else:
            for ar in ars:
                widths.append(ms * np.sqrt(ar))
                heights.append(ms / np.sqrt(ar))
            if max_sizes:
                s = np.sqrt(ms * max_sizes[min_sizes.index(ms)])
                widths.append(s)
                heights.append(s)
    widths = np.asarray(widths, np.float32)
    heights = np.asarray(heights, np.float32)
    cx = (np.arange(W, dtype=np.float32) + offset) * step_w
    cy = (np.arange(H, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    boxes = np.stack([
        (cxg[:, :, None] - widths / 2.0) / img_w,
        (cyg[:, :, None] - heights / 2.0) / img_h,
        (cxg[:, :, None] + widths / 2.0) / img_w,
        (cyg[:, :, None] + heights / 2.0) / img_h,
    ], axis=-1).astype(np.float32)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), boxes.shape)
    dev = _device(input, image)
    return _out(boxes, dev), _out(var, dev)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode target boxes against priors (``[T, P, 4]``) or decode
    offsets ``[T, P, 4]`` into xyxy boxes, center-size form with optional
    per-prior variances ``[P, 4]``. Capturable."""
    pb = prior_box
    pbv = (None if prior_box_var is None
           else torch.as_tensor(prior_box_var, device=target_box.device))
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    px = pb[:, 0] + pw / 2.0
    py = pb[:, 1] + ph / 2.0
    tb = target_box
    if code_type.lower().startswith("encode"):
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tx = tb[:, 0] + tw / 2.0
        ty = tb[:, 1] + th / 2.0
        out = torch.stack([
            (tx[:, None] - px[None, :]) / pw[None, :],
            (ty[:, None] - py[None, :]) / ph[None, :],
            torch.log(tw[:, None] / pw[None, :]),
            torch.log(th[:, None] / ph[None, :]),
        ], dim=-1)
        return out if pbv is None else out / pbv[None, :, :]
    t = tb if pbv is None else tb * pbv[None, :, :]
    ox = t[..., 0] * pw + px
    oy = t[..., 1] * ph + py
    ow = torch.exp(t[..., 2]) * pw
    oh = torch.exp(t[..., 3]) * ph
    return torch.stack([ox - ow / 2.0, oy - oh / 2.0,
                        ox + ow / 2.0 - norm, oy + oh / 2.0 - norm], dim=-1)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None, _clamp_min=True):
    """RoIAlign: each of the ``ph x pw`` bins of a RoI averages
    ``sampling_ratio``\\ ² bilinear samples (2 when not positive). Returns
    ``[R, C, ph, pw]``; gradients reach ``x``. Reads ``boxes_num`` on the
    host: not capturable."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    R = int(boxes.shape[0])
    img = _rois_per_image(boxes_num, R, x.device)
    offset = 0.5 if aligned else 0.0
    sr = sampling_ratio if sampling_ratio > 0 else 2
    b = boxes.to(x.dtype) if boxes.dtype != x.dtype else boxes
    x0 = b[:, 0] * spatial_scale - offset
    y0 = b[:, 1] * spatial_scale - offset
    x1 = b[:, 2] * spatial_scale - offset
    y1 = b[:, 3] * spatial_scale - offset
    rw, rh = x1 - x0, y1 - y0
    if not aligned and _clamp_min:
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bin_w = (rw / pw)[:, None, None]
    bin_h = (rh / ph)[:, None, None]
    dev = x.device
    iy = (torch.arange(ph, device=dev)[None, :, None] * bin_h
          + (torch.arange(sr, device=dev)[None, None, :] + 0.5) * bin_h / sr
          + y0[:, None, None]).reshape(R, ph * sr)
    ix = (torch.arange(pw, device=dev)[None, :, None] * bin_w
          + (torch.arange(sr, device=dev)[None, None, :] + 0.5) * bin_w / sr
          + x0[:, None, None]).reshape(R, pw * sr)
    yy = torch.clamp(iy, 0.0, H - 1.0)[:, :, None].expand(R, ph * sr,
                                                          pw * sr)
    xx = torch.clamp(ix, 0.0, W - 1.0)[:, None, :].expand(R, ph * sr,
                                                          pw * sr)
    y_lo = torch.floor(yy).long()
    x_lo = torch.floor(xx).long()
    y_hi = torch.clamp(y_lo + 1, max=H - 1)
    x_hi = torch.clamp(x_lo + 1, max=W - 1)
    ly = (yy - y_lo)[..., None]
    lx = (xx - x_lo)[..., None]
    r = img[:, None, None]
    # x[r, :, y, x] with the slice between advanced indices: [R, Y, X, C]
    v00, v01 = x[r, :, y_lo, x_lo], x[r, :, y_lo, x_hi]
    v10, v11 = x[r, :, y_hi, x_lo], x[r, :, y_hi, x_hi]
    vals = (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx
            + v10 * ly * (1 - lx) + v11 * ly * lx)
    vals = vals.permute(0, 3, 1, 2).reshape(R, C, ph, sr, pw, sr)
    return vals.mean(dim=(3, 5))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """RoIPool: integer bin boundaries (rounded RoI corners), the maximum
    within each bin, 0 for an empty bin. Returns ``[R, C, ph, pw]``. Reads
    ``boxes_num`` on the host: not capturable."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    R = int(boxes.shape[0])
    img = _rois_per_image(boxes_num, R, x.device)
    corners = torch.round(boxes * spatial_scale).to(torch.int64)
    x0, y0, x1, y1 = (corners[:, k] for k in range(4))
    rh = torch.clamp(y1 - y0 + 1, min=1)
    rw = torch.clamp(x1 - x0 + 1, min=1)
    feat = x[img]  # [R, C, H, W]
    gy = torch.arange(H, device=x.device)
    gx = torch.arange(W, device=x.device)
    rows = []
    for iy in range(ph):
        hs = torch.clamp(y0 + torch.div(iy * rh, ph, rounding_mode="floor"),
                         0, H)
        he = torch.clamp(y0 + torch.div((iy + 1) * rh + ph - 1, ph,
                                        rounding_mode="floor"), 0, H)
        row = []
        for ix in range(pw):
            ws = torch.clamp(
                x0 + torch.div(ix * rw, pw, rounding_mode="floor"), 0, W)
            we = torch.clamp(x0 + torch.div((ix + 1) * rw + pw - 1, pw,
                                            rounding_mode="floor"), 0, W)
            my = (gy[None, :] >= hs[:, None]) & (gy[None, :] < he[:, None])
            mx = (gx[None, :] >= ws[:, None]) & (gx[None, :] < we[:, None])
            m = my[:, :, None] & mx[:, None, :]  # [R, H, W]
            masked = torch.where(m[:, None], feat, -torch.inf)
            out = masked.amax(dim=(2, 3))
            row.append(torch.where(m.any(dim=(1, 2))[:, None], out, 0.0))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def _sce(logit, target):
    """Sigmoid cross entropy, in the stable form (the reference's
    ``SigmoidCrossEntropy``), in the reference's order of operations."""
    return (torch.clamp(logit, min=0.0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def _iou_cwh(x1, y1, w1, h1, x2, y2, w2, h2):
    ov_w = (torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
            - torch.maximum(x1 - w1 / 2, x2 - w2 / 2))
    ov_h = (torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
            - torch.maximum(y1 - h1 / 2, y2 - h2 / 2))
    inter = torch.where((ov_w > 0) & (ov_h > 0), ov_w * ov_h, 0.0)
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-10)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, scale_x_y=1.0, name=None):
    """YOLOv3 training loss, per image ``[N]``. ``x``: ``[N, mask_num (5 +
    class_num), H, W]``; ``gt_box``: ``[N, B, 4]`` normalized (cx, cy, w,
    h), a box of zero width or height is padding; ``gt_label``: ``[N, B]``
    (a label outside ``[0, class_num)`` targets no class); ``gt_score``:
    ``[N, B]`` mixup scores (default 1).

    Vectorized as the reference's form: the location and class terms
    gather each box's channels at its cell and best anchor; two boxes on
    one (anchor, cell) take the larger objectness score (``scatter_reduce``
    "amax"); the ignore mask is each prediction's best IoU against every
    valid box. Under ``auto_cast`` the dtypes are the reference's: the
    predictions, the grid and the objectness and class terms in ``x``'s
    dtype, the terms that meet the float32 boxes and anchors in float32.
    Capturable (after one eager call, which builds the anchor tables on
    the device). The gradient of the gather is an accumulating
    ``index_put``: on the card run-to-run bitwise only under
    ``torch.use_deterministic_algorithms(True)``."""
    an_num = len(anchors) // 2
    mask_num = len(anchor_mask)
    bias = -0.5 * (scale_x_y - 1.0)
    dev = x.device
    anc, m_anc, mask_lut = _anchor_consts(anchors, anchor_mask, dev)
    N, _, H, W = x.shape
    gtb = gt_box
    B = gtb.shape[1]
    input_size = downsample_ratio * H
    v = x.reshape(N, mask_num, 5 + class_num, H, W)
    lab = gt_label.to(torch.int64)
    score = (torch.ones((N, B), dtype=v.dtype, device=dev)
             if gt_score is None else gt_score)

    valid = (gtb[..., 2] > 1e-6) & (gtb[..., 3] > 1e-6)  # [N, B]

    # predicted boxes, for the ignore mask
    gx = torch.arange(W, dtype=v.dtype, device=dev)
    gy = torch.arange(H, dtype=v.dtype, device=dev)
    px = (gx[None, None, None, :] + torch.sigmoid(v[:, :, 0]) * scale_x_y
          + bias) / W
    py = (gy[None, None, :, None] + torch.sigmoid(v[:, :, 1]) * scale_x_y
          + bias) / H
    pw = torch.exp(v[:, :, 2]) * m_anc[None, :, 0, None, None] / input_size
    ph = torch.exp(v[:, :, 3]) * m_anc[None, :, 1, None, None] / input_size
    if B:
        g = gtb[:, None, None, None, :, :]
        ious = _iou_cwh(px[..., None], py[..., None], pw[..., None],
                        ph[..., None], g[..., 0], g[..., 1], g[..., 2],
                        g[..., 3])
        ious = torch.where(valid[:, None, None, None, :], ious, 0.0)
        best_iou = ious.amax(dim=-1)
    else:
        best_iou = torch.zeros_like(px)
    ignored = best_iou > ignore_thresh

    # each box's best anchor (shape IoU against every anchor)
    aw = anc[:, 0] / input_size
    ah = anc[:, 1] / input_size
    shape_iou = _iou_cwh(0.0, 0.0, gtb[..., 2:3], gtb[..., 3:4],
                         0.0, 0.0, aw[None, None, :], ah[None, None, :])
    best_n = torch.argmax(shape_iou, dim=-1)  # [N, B]
    mask_idx = mask_lut[best_n]  # -1 where not in this head
    pos = valid & (mask_idx >= 0)

    gi = torch.clamp((gtb[..., 0] * W).to(torch.int32), 0, W - 1).long()
    gj = torch.clamp((gtb[..., 1] * H).to(torch.int32), 0, H - 1).long()
    safe_mi = torch.clamp(mask_idx, min=0)
    bidx = torch.arange(N, device=dev)[:, None]
    # advanced indices around a slice: the broadcast dims come first
    pred = v[bidx, safe_mi, :, gj, gi]
    assert tuple(pred.shape) == (N, B, 5 + class_num), pred.shape

    tx = gtb[..., 0] * W - gi
    ty = gtb[..., 1] * H - gj
    tw = torch.log(gtb[..., 2] * input_size
                   / torch.clamp(anc[best_n, 0], min=1e-10) + 1e-10)
    th = torch.log(gtb[..., 3] * input_size
                   / torch.clamp(anc[best_n, 1], min=1e-10) + 1e-10)
    box_scale = (2.0 - gtb[..., 2] * gtb[..., 3]) * score
    loc = (_sce(pred[..., 0], tx) + _sce(pred[..., 1], ty)
           + torch.abs(pred[..., 2] - tw) + torch.abs(pred[..., 3] - th))
    loc_loss = torch.where(pos, loc * box_scale, 0.0).sum(dim=1)

    if use_label_smooth:
        smooth = min(1.0 / class_num, 1.0 / 40)
        pos_t, neg_t = 1.0 - smooth, smooth
    else:
        pos_t, neg_t = 1.0, 0.0
    # a label outside [0, class_num) matches no class (a zero one-hot row);
    # the targets are weak scalars in the reference: x's dtype
    hot = lab[..., None] == torch.arange(class_num, device=dev)
    cls_target = torch.where(hot, pos_t, neg_t).to(v.dtype)
    cls = _sce(pred[..., 5:], cls_target).sum(dim=-1)
    cls_loss = torch.where(pos, cls * score, 0.0).sum(dim=1)

    # objectness: the score at positives, -1 where ignored, else 0
    cell = ((bidx * mask_num + safe_mi) * H + gj) * W + gi
    obj_score = torch.zeros(N * mask_num * H * W, dtype=v.dtype, device=dev)
    obj_score = obj_score.scatter_reduce(
        0, cell.reshape(-1), torch.where(pos, score, 0.0).to(v.dtype)
        .reshape(-1), "amax", include_self=True).reshape(N, mask_num, H, W)
    obj = torch.where(obj_score > 1e-5, obj_score,
                      torch.where(ignored, -1.0, 0.0).to(v.dtype))
    pred_obj = v[:, :, 4]
    obj_loss = torch.where(
        obj > 1e-5, _sce(pred_obj, 1.0) * obj,
        torch.where(obj > -0.5, _sce(pred_obj, 0.0), 0.0))
    return loc_loss + cls_loss + obj_loss.sum(dim=(1, 2, 3))


def anchor_generator(input, anchor_sizes, aspect_ratios, stride,  # noqa: A002
                     variances=(0.1, 0.1, 0.2, 0.2), offset=0.5, name=None):
    """RPN anchors for a feature map ``[N, C, H, W]``: (anchors ``[H, W,
    A, 4]`` xyxy, variances of the same shape), centered at ``index *
    stride + offset * (stride - 1)``. Built on ``input``'s device from the
    shapes: capturable only after a first eager call (the sizes are
    copied to the device)."""
    H, W = int(input.shape[2]), int(input.shape[3])
    sizes = np.asarray(anchor_sizes, np.float32)
    ratios = np.asarray(aspect_ratios, np.float32)
    sw, sh = float(stride[0]), float(stride[1])
    ws, hs = [], []
    for r in ratios:
        base_area = sw * sh
        base_w = np.round(np.sqrt(base_area / r))
        base_h = np.round(base_w * r)
        for s in sizes:
            ws.append(0.5 * (base_w * (s / sw) - 1))
            hs.append(0.5 * (base_h * (s / sh) - 1))
    dev = input.device
    half = _const(("anchor_halves", tuple(map(float, ws)),
                   tuple(map(float, hs)), tuple(map(float, variances))), dev,
                  lambda d: (torch.tensor(np.asarray(ws, np.float32),
                                          device=d),
                             torch.tensor(np.asarray(hs, np.float32),
                                          device=d),
                             torch.tensor(variances, dtype=torch.float32,
                                          device=d)))
    half_w, half_h, var = half
    num = half_w.shape[0]
    cx = torch.arange(W, dtype=torch.float32, device=dev) * sw \
        + offset * (sw - 1)
    cy = torch.arange(H, dtype=torch.float32, device=dev) * sh \
        + offset * (sh - 1)
    cxb = cx[None, :, None].expand(H, W, num)
    cyb = cy[:, None, None].expand(H, W, num)
    anchors = torch.stack([cxb - half_w, cyb - half_h, cxb + half_w,
                           cyb + half_h], dim=-1)
    return anchors, var.expand(H, W, num, 4)


def iou_similarity(x, y, box_normalized=True):
    """Pairwise IoU ``[N, M]`` of two xyxy box sets (``box_normalized=False``
    counts pixel extents, +1). Capturable."""
    off = 0.0 if box_normalized else 1.0
    ax0, ay0, ax1, ay1 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    bx0, by0, bx1, by1 = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
    area_a = (ax1 - ax0 + off) * (ay1 - ay0 + off)
    area_b = (bx1 - bx0 + off) * (by1 - by0 + off)
    iw = (torch.minimum(ax1[:, None], bx1[None, :])
          - torch.maximum(ax0[:, None], bx0[None, :]) + off)
    ih = (torch.minimum(ay1[:, None], by1[None, :])
          - torch.maximum(ay0[:, None], by0[None, :]) + off)
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-10)


def box_clip(input, im_info, name=None):  # noqa: A002
    """Clip xyxy boxes (``[B, 4]``, or ``[N, B, 4]`` with a row of
    ``im_info`` per image) to ``[0, dim / scale - 1]``; ``im_info`` rows are
    (height, width, scale). Capturable."""
    info = torch.as_tensor(im_info, device=input.device)
    h = info[..., 0] / info[..., 2] - 1.0
    w = info[..., 1] / info[..., 2] - 1.0
    if input.ndim == 3:
        h, w = h[:, None], w[:, None]
    else:
        h, w = h.reshape(()), w.reshape(())
    zero = torch.zeros((), dtype=input.dtype, device=input.device)
    return torch.stack([torch.clamp(input[..., 0], zero, w),
                        torch.clamp(input[..., 1], zero, h),
                        torch.clamp(input[..., 2], zero, w),
                        torch.clamp(input[..., 3], zero, h)], dim=-1)


def prroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Precise RoI pooling, as the average of 4 x 4 bilinear samples a bin
    (RoIAlign without the one-pixel minimum size). Reads ``boxes_num`` on
    the host: not capturable."""
    return roi_align(x, boxes, boxes_num, output_size,
                     spatial_scale=spatial_scale, sampling_ratio=4,
                     aligned=False, _clamp_min=False)


def density_prior_box(input, image, densities, fixed_sizes,  # noqa: A002
                      fixed_ratios, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, step=(0.0, 0.0), offset=0.5):
    """Density prior boxes: SSD priors on a ``density x density`` subgrid of
    each cell per (fixed size, ratio). Returns (boxes ``[H, W, P, 4]``,
    variances), ``P = sum(density²) x len(fixed_ratios)``. Computed on the
    host from the shapes, then put on ``input``'s device: not
    capturable."""
    H, W = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    step_w = step[0] or img_w / W
    step_h = step[1] or img_h / H
    boxes = []
    for s, density in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw, bh = s * np.sqrt(ratio), s / np.sqrt(ratio)
            shift = 1.0 / density
            for di in range(density):
                for dj in range(density):
                    boxes.append(((dj + 0.5) * shift - 0.5,
                                  (di + 0.5) * shift - 0.5, bw, bh))
    P = len(boxes)
    ys, xs = np.mgrid[0:H, 0:W]
    cx = (xs + offset)[:, :, None] * step_w \
        + np.array([b[0] for b in boxes]) * step_w
    cy = (ys + offset)[:, :, None] * step_h \
        + np.array([b[1] for b in boxes]) * step_h
    bw = np.broadcast_to(np.array([b[2] for b in boxes]) / 2.0, (H, W, P))
    bh = np.broadcast_to(np.array([b[3] for b in boxes]) / 2.0, (H, W, P))
    out = np.stack([(cx - bw) / img_w, (cy - bh) / img_h,
                    (cx + bw) / img_w, (cy + bh) / img_h],
                   axis=-1).astype(np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), (H, W, P, 4))
    dev = _device(input, image)
    return _out(out, dev), _out(var, dev)


# -- host ops: the output's size depends on the data ------------------------

def _iou_matrix(boxes):
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    ix0 = np.maximum(x0[:, None], x0[None, :])
    iy0 = np.maximum(y0[:, None], y0[None, :])
    ix1 = np.minimum(x1[:, None], x1[None, :])
    iy1 = np.minimum(y1[:, None], y1[None, :])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    union = area[:, None] + area[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def _nms_np(b, iou_threshold, s=None, category_idxs=None, categories=None,
            top_k=None):
    order = np.argsort(-s) if s is not None else np.arange(len(b))
    if category_idxs is not None:
        cats = category_idxs
        keep_all = []
        for c in (categories if categories is not None else np.unique(cats)):
            idx = np.where(cats == c)[0]
            if len(idx) == 0:
                continue
            sub = _nms_np(b[idx], iou_threshold,
                          None if s is None else s[idx])
            keep_all.extend(idx[sub])
        keep_all = np.asarray(sorted(
            keep_all, key=(lambda i: -s[i]) if s is not None else None),
            dtype=np.int64)
        return keep_all if top_k is None else keep_all[:top_k]
    iou = _iou_matrix(b)
    keep = []
    suppressed = np.zeros(len(b), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_threshold
    keep = np.asarray(keep, np.int64)
    return keep if top_k is None else keep[:top_k]


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS over xyxy ``boxes``, highest score first (per category
    with ``category_idxs``): the kept indices (int64), best first. On the
    host, as the reference runs it: not capturable."""
    keep = _nms_np(_np(boxes), iou_threshold,
                   None if scores is None else _np(scores),
                   None if category_idxs is None else _np(category_idxs),
                   categories, top_k)
    return _out(keep, _device(boxes, scores))


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    """Per image and class (but ``background_label``): the boxes scoring
    above ``score_threshold``, the ``nms_top_k`` best, greedy NMS; then the
    ``keep_top_k`` best of the image. ``bboxes [N, M, 4]``, ``scores [N,
    C, M]``; returns rows ``[K, 6]`` (label, score, x0, y0, x1, y1) and the
    count per image. On the host (the device inputs read back once), as
    the reference runs it: not capturable."""
    bv, sv = _np(bboxes), _np(scores)
    N, C, M = sv.shape
    outs, counts = [], []
    for n in range(N):
        dets = []
        for c in range(C):
            if c == background_label:
                continue
            idx = np.where(sv[n, c] > score_threshold)[0]
            if len(idx) == 0:
                continue
            sc = sv[n, c, idx]
            top = (np.argsort(-sc)[:nms_top_k] if nms_top_k > 0
                   else np.argsort(-sc))
            idx = idx[top]
            keep = _nms_np(bv[n, idx], nms_threshold, sv[n, c, idx])
            for k in idx[keep]:
                dets.append([c, sv[n, c, k], *bv[n, k]])
        dets.sort(key=lambda d: -d[1])
        if keep_top_k > 0:
            dets = dets[:keep_top_k]
        counts.append(len(dets))
        outs.extend(dets)
    out = (np.asarray(outs, np.float32).reshape(-1, 6) if outs
           else np.zeros((0, 6), np.float32))
    dev = _device(bboxes, scores)
    return _out(out, dev), _out(np.asarray(counts, np.int32), dev)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True):
    """Matrix NMS (SOLOv2's parallel soft suppression): per class each
    score decays by its IoU with higher-scored boxes, compensated by their
    own best IoU. ``bboxes [B, N, 4]``, ``scores [B, C, N]``; returns rows
    ``[K, 8]`` (batch, class, score, x1, y1, x2, y2, 0) and the count per
    image. On the host: not capturable."""
    bb, sc = _np(bboxes, np.float32), _np(scores, np.float32)
    B, C, N = sc.shape
    rows, per_batch = [], []
    for b in range(B):
        cand = []
        for c in range(C):
            if c == background_label:
                continue
            keep = np.nonzero(sc[b, c] > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-sc[b, c, keep])]
            if nms_top_k > 0:
                order = order[:nms_top_k]
            boxes = bb[b, order]
            s = sc[b, c, order].copy()
            n = order.size
            iou = np.triu(_iou_xyxy(boxes, boxes), 1)
            comp = iou.max(axis=0, initial=0.0)
            if use_gaussian:
                decay = np.exp(-(iou ** 2 - comp[:, None] ** 2)
                               * gaussian_sigma)
            else:
                decay = (1.0 - iou) / np.maximum(1.0 - comp[:, None], 1e-10)
            decay_j = np.where(np.triu(np.ones((n, n), bool), 1), decay,
                               np.inf).min(axis=0)
            s = s * np.where(np.isinf(decay_j), 1.0, decay_j)
            for j in range(n):
                if s[j] > post_threshold:
                    cand.append((c, s[j], *boxes[j]))
        cand.sort(key=lambda r: -r[1])
        if keep_top_k > 0:
            cand = cand[:keep_top_k]
        per_batch.append(len(cand))
        for c, sval, x1, y1, x2, y2 in cand:
            rows.append((b, c, sval, x1, y1, x2, y2, 0.0))
    out = (np.asarray(rows, np.float32) if rows
           else np.zeros((0, 8), np.float32))
    dev = _device(bboxes, scores)
    return _out(out, dev), _out(np.asarray(per_batch, np.int64), dev)


def _iou_xyxy(a, b):
    """Pairwise IoU of ``[N, 4]`` and ``[M, 4]`` corner boxes (numpy)."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-10)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=False):
    """RPN proposals, per image: the ``pre_nms_top_n`` best anchors,
    decoded (center size, per-anchor variances), clipped to the image,
    boxes under ``min_size`` dropped, NMS, the ``post_nms_top_n`` best
    kept. Returns rois ``[N, post_nms_top_n, 4]`` and scores, zero-padded
    (and the count per image). On the host: not capturable."""
    sc = _np(scores, np.float32)         # [N, A, H, W]
    bd = _np(bbox_deltas, np.float32)    # [N, 4A, H, W]
    ims = _np(img_size, np.float32)      # [N, 2] (h, w)
    an = _np(anchors, np.float32).reshape(-1, 4)
    var = _np(variances, np.float32).reshape(-1, 4)
    N, A, H, W = sc.shape
    all_rois = np.zeros((N, post_nms_top_n, 4), np.float32)
    all_scores = np.zeros((N, post_nms_top_n), np.float32)
    rois_num = np.zeros((N,), np.int32)
    for n in range(N):
        s = sc[n].transpose(1, 2, 0).reshape(-1)
        d = bd[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], var[order]
        aw = a[:, 2] - a[:, 0] + 1.0
        ah = a[:, 3] - a[:, 1] + 1.0
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = np.exp(np.minimum(v[:, 2] * d[:, 2], np.log(1000 / 16.0))) * aw
        h = np.exp(np.minimum(v[:, 3] * d[:, 3], np.log(1000 / 16.0))) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         axis=1)
        ih, iw = ims[n]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - 1)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - 1)
        keep = ((boxes[:, 2] - boxes[:, 0] >= min_size)
                & (boxes[:, 3] - boxes[:, 1] >= min_size))
        boxes, s = boxes[keep], s[keep]
        if len(boxes):
            k = _nms_np(boxes, nms_thresh, s, top_k=post_nms_top_n)
            all_rois[n, :len(k)] = boxes[k]
            all_scores[n, :len(k)] = s[k]
            rois_num[n] = len(k)
    dev = _device(scores, bbox_deltas)
    out = (_out(all_rois, dev), _out(all_scores, dev))
    return out + (_out(rois_num, dev),) if return_rois_num else out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Each RoI to the FPN level ``floor(log2(sqrt(area) / refer_scale)) +
    refer_level``, clipped to ``[min_level, max_level]``: the RoIs of each
    level and the index that restores their original order. On the host:
    not capturable."""
    rois = _np(fpn_rois)
    offset = 1.0 if pixel_offset else 0.0
    ws = np.maximum(rois[:, 2] - rois[:, 0] + offset, 0)
    hs = np.maximum(rois[:, 3] - rois[:, 1] + offset, 0)
    lvl = np.floor(np.log2(np.sqrt(ws * hs) / refer_scale + 1e-8)) \
        + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    dev = _device(fpn_rois)
    outs, idxs = [], []
    for level in range(min_level, max_level + 1):
        sel = np.where(lvl == level)[0]
        outs.append(_out(rois[sel], dev))
        idxs.append(sel)
    restore = np.argsort(np.concatenate(idxs)).astype(np.int64)
    return outs, _out(restore, dev)


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5):
    """Greedy bipartite matching of a (gt rows, prediction columns)
    distance matrix ``[B, N, M]`` or ``[N, M]``: the global maximum pair is
    bound and both removed, repeatedly; ``per_prediction`` then gives each
    unmatched column its best row at or above ``dist_threshold``. Returns
    (match indices int64, -1 unmatched; match distances). On the host:
    not capturable."""
    dm = _np(dist_matrix).astype(np.float32)
    squeeze = dm.ndim == 2
    if squeeze:
        dm = dm[None]
    B, N, M = dm.shape
    match_idx = np.full((B, M), -1, np.int64)
    match_dist = np.zeros((B, M), np.float32)
    for b in range(B):
        d = dm[b].copy()
        for _ in range(min(N, M)):
            r, c = np.unravel_index(np.argmax(d), d.shape)
            if d[r, c] <= 0:
                break
            match_idx[b, c] = r
            match_dist[b, c] = d[r, c]
            d[r, :] = -1.0
            d[:, c] = -1.0
        if match_type == "per_prediction":
            for c in range(M):
                if match_idx[b, c] >= 0:
                    continue
                r = int(np.argmax(dm[b, :, c]))
                if dm[b, r, c] >= dist_threshold:
                    match_idx[b, c] = r
                    match_dist[b, c] = dm[b, r, c]
    if squeeze:
        match_idx, match_dist = match_idx[0], match_dist[0]
    dev = _device(dist_matrix)
    return _out(match_idx, dev), _out(match_dist, dev)


def target_assign(input, match_indices, negative_indices=None,  # noqa: A002
                  mismatch_value=0):
    """Per-prediction targets by match index: ``out[b, m] = input[b,
    match[b, m]]``, ``mismatch_value`` with weight 0 where the match is -1;
    ``negative_indices`` get weight 1 (their target stays the mismatch
    value). No gradient, as in the reference. Capturable without
    ``negative_indices`` (read on the host)."""
    with torch.no_grad():
        match = torch.as_tensor(match_indices, device=input.device).long()
        safe = torch.clamp(match, min=0)
        bidx = torch.arange(input.shape[0], device=input.device)[:, None]
        gathered = input[bidx, safe]
        matched = match >= 0
        out = torch.where(matched[..., None] if gathered.ndim == 3
                          else matched, gathered,
                          torch.tensor(mismatch_value, dtype=gathered.dtype,
                                       device=input.device))
        wt = matched.float()
    if negative_indices is not None:
        neg = _np(negative_indices).astype(np.int64)
        wt_np = _np(wt).copy()
        for b in range(wt_np.shape[0]):
            wt_np[b, neg[b][neg[b] >= 0]] = 1.0
        wt = _out(wt_np, input.device)
    return out, wt


def rpn_target_assign(anchors, gt_boxes, is_crowd=None,
                      rpn_batch_size_per_im=256, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      use_random=False, seed=0):
    """RPN anchor sampling for ONE image: positives are each gt's best
    anchors and every anchor above ``rpn_positive_overlap``; negatives
    those below ``rpn_negative_overlap``, down to the batch budget (the
    first ones, or drawn from ``seed`` with ``use_random``). Returns
    (loc_index, score_index, bbox targets, labels). On the host: not
    capturable."""
    A = _np(anchors, np.float32).reshape(-1, 4)
    G = _np(gt_boxes, np.float32).reshape(-1, 4)
    crowd = (_np(is_crowd).reshape(-1).astype(bool)
             if is_crowd is not None else np.zeros(len(G), bool))
    G_use = G[~crowd]
    iou = _iou_xyxy(A, G_use) if len(G_use) else np.zeros((len(A), 1))
    best_gt = iou.argmax(axis=1)
    best_iou = iou.max(axis=1) if iou.size else np.zeros(len(A))
    labels = np.full(len(A), -1, np.int64)
    if len(G_use):
        per_gt_best = iou.max(axis=0)
        for g in range(iou.shape[1]):
            if per_gt_best[g] > 0:
                labels[iou[:, g] >= per_gt_best[g] - 1e-9] = 1
        labels[best_iou >= rpn_positive_overlap] = 1
    neg_cand = np.nonzero(best_iou < rpn_negative_overlap)[0]
    neg_cand = neg_cand[labels[neg_cand] != 1]
    rng = np.random.RandomState(seed)
    n_fg = int(rpn_batch_size_per_im * rpn_fg_fraction)
    fg = np.nonzero(labels == 1)[0]
    if len(fg) > n_fg:
        drop = (rng.choice(fg, len(fg) - n_fg, replace=False)
                if use_random else fg[n_fg:])
        labels[drop] = -1
        fg = np.nonzero(labels == 1)[0]
    n_bg = rpn_batch_size_per_im - len(fg)
    if len(neg_cand) > n_bg:
        bg = (rng.choice(neg_cand, n_bg, replace=False)
              if use_random else neg_cand[:n_bg])
    else:
        bg = neg_cand
    labels[bg] = 0
    loc_index = np.nonzero(labels == 1)[0]
    score_index = np.concatenate([loc_index, np.nonzero(labels == 0)[0]])
    tgt = np.zeros((len(loc_index), 4), np.float32)
    if len(loc_index) and len(G_use):
        a = A[loc_index]
        g = G_use[best_gt[loc_index]]
        aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
        ax, ay = a[:, 0] + aw / 2, a[:, 1] + ah / 2
        gw, gh = g[:, 2] - g[:, 0], g[:, 3] - g[:, 1]
        gx, gy = g[:, 0] + gw / 2, g[:, 1] + gh / 2
        tgt = np.stack([(gx - ax) / np.maximum(aw, 1e-6),
                        (gy - ay) / np.maximum(ah, 1e-6),
                        np.log(np.maximum(gw, 1e-6) / np.maximum(aw, 1e-6)),
                        np.log(np.maximum(gh, 1e-6) / np.maximum(ah, 1e-6))],
                       axis=1).astype(np.float32)
    dev = _device(anchors, gt_boxes)
    return (_out(loc_index, dev), _out(score_index, dev), _out(tgt, dev),
            _out(labels[score_index].astype(np.int64), dev))


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       mining_type="max_negative", sample_size=None):
    """SSD hard-negative mining (``max_negative``): per image the
    highest-loss unmatched predictions, ``neg_pos_ratio`` x the positives
    (or ``sample_size``), sorted; ``[B, max_neg]`` padded with -1. On the
    host: not capturable."""
    if mining_type != "max_negative":
        raise NotImplementedError(
            "mine_hard_examples: only max_negative mining is implemented "
            "(hard_example mode needs the full loss, like the reference)")
    loss = _np(cls_loss, np.float32)
    match = _np(match_indices).astype(np.int64)
    B, P = match.shape
    per_img = []
    for b in range(B):
        pos = int((match[b] >= 0).sum())
        budget = (int(sample_size) if sample_size is not None
                  else int(neg_pos_ratio * pos))
        negs = np.nonzero(match[b] < 0)[0]
        per_img.append(np.sort(negs[np.argsort(-loss[b, negs])][:budget]))
    width = max((len(x) for x in per_img), default=0)
    out = np.full((B, max(width, 1)), -1, np.int64)
    for b, idx in enumerate(per_img):
        out[b, :len(idx)] = idx
    return _out(out, _device(cls_loss, match_indices))


def detection_map(detect_res, gt_label_box, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version="integral"):
    """Detection mAP (VOC's ``11point`` or ``integral`` AP) over the
    non-background classes present in the ground truth. ``detect_res``
    rows: (image, class, score, x1, y1, x2, y2); ``gt_label_box`` rows:
    (image, class, difficult, x1, y1, x2, y2). A float32 scalar. On the
    host: not capturable."""
    det = _np(detect_res, np.float32).reshape(-1, 7)
    gt = _np(gt_label_box, np.float32).reshape(-1, 7)
    if len(gt) and gt[:, 1].max() >= class_num:
        raise ValueError(
            f"gt class id {int(gt[:, 1].max())} >= class_num {class_num}")
    aps = []
    for c in np.unique(gt[:, 1]).astype(int):
        if c == background_label:
            continue
        gt_c = gt[gt[:, 1] == c]
        difficult = gt_c[:, 2] != 0
        # VOC: a difficult gt stays matchable, but a detection matching it
        # is neither a TP nor an FP and it leaves the recall's denominator
        n_gt = (int((~difficult).sum()) if not evaluate_difficult
                else len(gt_c))
        det_c = det[det[:, 1] == c]
        det_c = det_c[np.argsort(-det_c[:, 2])]
        matched = set()
        tp = np.zeros(len(det_c))
        fp = np.zeros(len(det_c))
        for i, d in enumerate(det_c):
            cand_idx = np.nonzero(gt_c[:, 0] == d[0])[0]
            if len(cand_idx) == 0:
                fp[i] = 1
                continue
            iou = _iou_xyxy(d[None, 3:7], gt_c[cand_idx, 3:7])[0]
            j = int(iou.argmax())
            if iou[j] >= overlap_threshold:
                if not evaluate_difficult and difficult[cand_idx[j]]:
                    continue
                if (d[0], cand_idx[j]) not in matched:
                    tp[i] = 1
                    matched.add((d[0], cand_idx[j]))
                else:
                    fp[i] = 1
            else:
                fp[i] = 1
        if n_gt == 0:
            continue
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-10)
        if ap_version == "11point":
            ap = float(np.mean([
                precision[recall >= t].max() if (recall >= t).any() else 0.0
                for t in np.linspace(0, 1, 11)]))
        else:
            ap, prev_r = 0.0, 0.0
            for p, r in zip(precision, recall):
                ap += p * (r - prev_r)
                prev_r = r
            ap = float(ap)
        aps.append(ap)
    m = float(np.mean(aps)) if aps else 0.0
    return torch.tensor(m, dtype=torch.float32,
                        device=_device(detect_res, gt_label_box))
