"""The port's detection ops (``paddle_tpu_torch.vision.ops``) and config 5's
training step on the CPU, against the reference (``paddle_tpu.vision.ops``).

Every op of the reference module runs on the reference tests' own cases
(``tests/test_op_tail2.py``'s yolov3 inputs and anchor generator,
``tests/test_op_families.py``'s RoI and proposal cases) and on one seeded
case each, the same numpy inputs on both sides.

Tolerances:

- the dense ops in float32 (``yolov3_loss``, ``yolo_box``, ``box_coder``,
  ``prior_box``, ``anchor_generator``, ``density_prior_box``,
  ``iou_similarity``, ``box_clip`` and the RoI pools): the same math in
  another order, ``rtol = atol = 1e-5`` (``yolov3_loss``: 1e-5 of each
  image's loss); the gradient of ``yolov3_loss`` with respect to ``x``:
  1e-5 relative L2;
- the host ops (NMS, proposals, matching, targets, mining, mAP): the same
  numpy code on the same arrays, exact;
- ``yolov3_loss`` under bf16 ``auto_cast`` against the reference's under
  its ``auto_cast``: 1e-2 relative (bf16 rounds in other places), and the
  port's dtypes equal the reference's;
- config 5's step (``benchmarks/run_all.py:255-330`` at its CPU size: sizes
  64 then 96, batch 2, bf16 ``auto_cast``, ``Momentum(0.01, 0.9)``), two
  steps against the reference's ``to_static`` step, each from the
  reference's state before it (parameters, running statistics and
  velocities; a free run amplifies rounding: at this size the loss halves
  in a step). In float32 (no ``auto_cast``) each loss within 1e-5 relative
  and each step's update of the parameters within 1e-3 relative L2. In
  bf16 each loss within 1e-2 relative; the update is decided by rounding at
  this size (the last stages normalise 2 x 2 maps over a batch of 2: the
  reference's own bf16 update is 0.39 relative L2 from its float32 update
  of the same step), so the port's bf16 update is held to within 1.5 x the
  reference's bf16 distance from the reference's float32 update.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import ops as R
import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import ops as T

DENSE = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5
AMP_REL = 1e-2
BF16_LOSS_REL, BF16_UPDATE_FACTOR = 1e-2, 1.5
F32_LOSS_REL, F32_UPDATE_REL = 1e-5, 1e-3

ANCHORS9 = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
            198, 373, 326]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ref(x):
    return paddle.to_tensor(x) if isinstance(x, np.ndarray) else x


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x


def _np(out):
    if isinstance(out, (list, tuple)):
        return [_np(o) for o in out]
    if isinstance(out, torch.Tensor):
        return out.detach().float().numpy() if out.is_floating_point() \
            else out.numpy()
    return np.asarray(out.numpy())


def both(name, *args, **kwargs):
    """(reference outputs, port outputs) of op ``name`` on the same numpy
    inputs, as numpy."""
    ref = getattr(R, name)(*map(_ref, args), **{
        k: _ref(v) for k, v in kwargs.items()})
    port = getattr(T, name)(*map(_port, args), **{
        k: _port(v) for k, v in kwargs.items()})
    return _np(ref), _np(port)


def assert_close(ref, port, exact=False):
    if isinstance(ref, list):
        assert len(ref) == len(port)
        for r, p in zip(ref, port):
            assert_close(r, p, exact)
        return
    assert np.shape(ref) == np.shape(port)
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, **DENSE)


# -- the reference tests' yolov3 inputs and a seeded case ---------------------

def _yolo_small():
    """tests/test_op_tail2.py's TestDetectionMisc._yolo_inputs."""
    rng = np.random.RandomState(0)
    N, H, W, C = 2, 4, 4, 3
    mask, anchors = [0, 1], [10, 13, 16, 30, 33, 23]
    x = (rng.randn(N, len(mask) * (5 + C), H, W) * 0.1).astype(np.float32)
    gtb = np.array([[[.3, .3, .2, .2], [.7, .6, .3, .4]],
                    [[.5, .5, .4, .3], [0, 0, 0, 0]]], np.float32)
    gtl = np.array([[0, 2], [1, 0]], np.int64)
    return x, gtb, gtl, anchors, mask, C, 0.7, 8


def _yolo_seeded():
    """13 x 13 at 80 classes, the last three of nine anchors, ragged boxes
    (some padding, a label outside [0, 80) and two boxes on one cell)."""
    rng = np.random.RandomState(5)
    N, H, C, B = 2, 13, 80, 12
    x = rng.randn(N, 3 * (5 + C), H, H).astype(np.float32)
    gtb = np.zeros((N, B, 4), np.float32)
    gtb[:, :9, :2] = rng.rand(N, 9, 2) * 0.8 + 0.1
    gtb[:, :9, 2:] = rng.rand(N, 9, 2) * 0.6 + 0.05
    gtb[0, 9] = gtb[0, 0] * np.array([1, 1, 1.1, 0.9], np.float32)
    gtl = rng.randint(0, C, (N, B)).astype(np.int64)
    gtl[1, 2] = C + 3
    return x, gtb, gtl, ANCHORS9, [6, 7, 8], C, 0.5, 32


@pytest.mark.parametrize("case", [_yolo_small, _yolo_seeded])
@pytest.mark.parametrize("scored", [False, True])
def test_yolov3_loss_matches_the_reference(case, scored):
    x, gtb, gtl, anchors, mask, C, ignore, ds = case()
    kw = {}
    if scored:
        kw["gt_score"] = np.random.RandomState(7).rand(
            *gtl.shape).astype(np.float32)
    ref, port = both("yolov3_loss", x, gtb, gtl, anchors, mask, C, ignore,
                     ds, **kw)
    assert port.shape == (x.shape[0],) and (port > 0).all()
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=0)


@pytest.fixture(scope="module")
def yolo_grads():
    """d(sum of the losses)/dx on both sides, the seeded case (the
    reference's gradient compile dominates: computed once)."""
    x, gtb, gtl, anchors, mask, C, ignore, ds = _yolo_seeded()
    xr = paddle.to_tensor(x)
    xr.stop_gradient = False
    R.yolov3_loss(xr, paddle.to_tensor(gtb), paddle.to_tensor(gtl), anchors,
                  mask, C, ignore, ds).sum().backward()
    xp = torch.from_numpy(x).requires_grad_(True)
    T.yolov3_loss(xp, torch.from_numpy(gtb), torch.from_numpy(gtl), anchors,
                  mask, C, ignore, ds).sum().backward()
    return np.asarray(xr.grad.numpy()), xp.grad.numpy()


def test_yolov3_loss_gradient_matches_the_reference(yolo_grads):
    ref, port = yolo_grads
    assert np.isfinite(port).all() and np.abs(port).sum() > 0
    assert _rel(port, ref) <= GRAD_REL


def test_yolov3_loss_under_bf16_auto_cast_matches_the_reference():
    x, gtb, gtl, anchors, mask, C, ignore, ds = _yolo_seeded()
    xr = paddle.to_tensor(x).astype("bfloat16")
    with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
        ref = R.yolov3_loss(xr, paddle.to_tensor(gtb), paddle.to_tensor(gtl),
                            anchors, mask, C, ignore, ds)
    xp = torch.from_numpy(x).to(torch.bfloat16)
    with pt.amp.auto_cast(enable=True, dtype="bfloat16"):
        port = T.yolov3_loss(xp, torch.from_numpy(gtb),
                             torch.from_numpy(gtl), anchors, mask, C, ignore,
                             ds)
    assert str(port.dtype).split(".")[-1] == str(ref.dtype).split(".")[-1] \
        == "float32"
    r = np.asarray(ref.numpy(), np.float64)
    assert np.max(np.abs(port.double().numpy() - r) / np.abs(r)) <= AMP_REL
    f32 = T.yolov3_loss(torch.from_numpy(x), torch.from_numpy(gtb),
                        torch.from_numpy(gtl), anchors, mask, C, ignore, ds)
    assert torch.allclose(port, f32, rtol=AMP_REL, atol=0)


def test_yolov3_loss_gathers_broadcast_dims_first_and_builds_tables_once():
    x, gtb, gtl, anchors, mask, C, ignore, ds = _yolo_small()
    args = (torch.from_numpy(x), torch.from_numpy(gtb), torch.from_numpy(gtl),
            anchors, mask, C, ignore, ds)
    T.yolov3_loss(*args)
    n = len(T._CONSTS)
    T.yolov3_loss(*args)
    assert len(T._CONSTS) == n  # one table per (anchors, mask, device)


# -- the box ops --------------------------------------------------------------

def test_yolo_box_matches_the_reference():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3 * 85, 13, 13).astype(np.float32)
    img = np.array([[416, 416], [320, 480]], np.int32)
    for kw in ({}, {"clip_bbox": False, "scale_x_y": 1.05}):
        ref, port = both("yolo_box", x, img, ANCHORS9[12:], 80, 0.01, 32,
                         **kw)
        assert port[0].shape == (2, 13 * 13 * 3, 4)
        assert port[1].shape == (2, 13 * 13 * 3, 80)
        np.testing.assert_allclose(port[0], ref[0], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(port[1], ref[1], **DENSE)


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[30.0], aspect_ratios=[1.0]),
    dict(min_sizes=[30.0, 60.0], max_sizes=[60.0, 90.0],
         aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    dict(min_sizes=[20.0], max_sizes=[40.0], aspect_ratios=[2.0], flip=True,
         min_max_aspect_ratios_order=True, steps=(8.0, 8.0), offset=0.25)])
def test_prior_box_matches_the_reference(kw):
    feat = np.zeros((1, 8, 5, 6), np.float32)
    image = np.zeros((1, 3, 48, 40), np.float32)
    ref, port = both("prior_box", feat, image, **kw)
    assert_close(ref, port)


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_encodes_and_decodes_as_the_reference(normalized):
    rng = np.random.RandomState(2)
    prior = np.sort(rng.rand(7, 4).astype(np.float32) * 10, axis=1)
    var = np.full((7, 4), 0.2, np.float32)
    target = np.sort(rng.rand(5, 4).astype(np.float32) * 10, axis=1)
    ref, port = both("box_coder", prior, var, target, "encode_center_size",
                     normalized)
    assert_close(ref, port)
    deltas = rng.randn(5, 7, 4).astype(np.float32) * 0.3
    for v in (var, None):
        ref, port = both("box_coder", prior, v, deltas,
                         "decode_center_size", normalized)
        assert_close(ref, port)


def test_anchor_generator_matches_the_reference():
    # tests/test_op_tail2.py's case, then a seeded one
    ref, port = both("anchor_generator", np.zeros((1, 8, 2, 3), np.float32),
                     [64.0], [1.0], [16.0, 16.0])
    assert_close(ref, port)
    np.testing.assert_allclose(port[0][0, 1, 0, 0] - port[0][0, 0, 0, 0],
                               16.0)
    ref, port = both("anchor_generator", np.zeros((2, 4, 5, 7), np.float32),
                     [32.0, 64.0, 128.0], [0.5, 1.0, 2.0], [8.0, 8.0],
                     variances=(0.1, 0.1, 0.3, 0.3), offset=0.3)
    assert_close(ref, port)


@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity_matches_the_reference(normalized):
    rng = np.random.RandomState(3)
    a = np.sort(rng.rand(6, 4).astype(np.float32) * 9, axis=1)
    b = np.sort(rng.rand(4, 4).astype(np.float32) * 9, axis=1)
    ref, port = both("iou_similarity", a, b, box_normalized=normalized)
    assert_close(ref, port)


def test_box_clip_matches_the_reference():
    rng = np.random.RandomState(4)
    boxes = (rng.randn(2, 5, 4) * 40 + 20).astype(np.float32)
    info = np.array([[30, 50, 1.0], [64, 48, 2.0]], np.float32)
    assert_close(*both("box_clip", boxes, info))
    assert_close(*both("box_clip", boxes[0], info[:1]))


def test_density_prior_box_matches_the_reference():
    feat = np.zeros((1, 8, 4, 5), np.float32)
    image = np.zeros((1, 3, 32, 40), np.float32)
    for kw in ({}, {"clip": True, "step": (6.0, 7.0), "offset": 0.3}):
        ref, port = both("density_prior_box", feat, image, [2, 1],
                         [8.0, 16.0], [1.0, 2.0], **kw)
        assert_close(ref, port)


# -- NMS ----------------------------------------------------------------------

def _boxes(rng, n, scale=20.0):
    xy = rng.rand(n, 2).astype(np.float32) * scale
    wh = rng.rand(n, 2).astype(np.float32) * scale / 2 + 1
    return np.concatenate([xy, xy + wh], 1)


def test_nms_matches_the_reference():
    rng = np.random.RandomState(6)
    b, s = _boxes(rng, 40), rng.rand(40).astype(np.float32)
    cats = rng.randint(0, 3, 40).astype(np.int64)
    for kw in ({}, {"top_k": 7}, {"category_idxs": cats},
               {"category_idxs": cats, "categories": [0, 2], "top_k": 9}):
        ref, port = both("nms", b, 0.4, s, **kw)
        assert_close(ref, port, exact=True)
        assert port.dtype == np.int64


def test_multiclass_nms_matches_the_reference():
    rng = np.random.RandomState(8)
    b = np.stack([_boxes(rng, 30) for _ in range(2)])
    s = rng.rand(2, 4, 30).astype(np.float32)
    for kw in (dict(score_threshold=0.3, nms_top_k=10, keep_top_k=12),
               dict(score_threshold=0.01, nms_top_k=1000, keep_top_k=100,
                    nms_threshold=0.45, background_label=-1)):
        ref, port = both("multiclass_nms", b, s, **kw)
        assert_close(ref, port, exact=True)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_matches_the_reference(gaussian):
    rng = np.random.RandomState(9)
    b = np.stack([_boxes(rng, 25) for _ in range(2)])
    s = rng.rand(2, 3, 25).astype(np.float32)
    ref, port = both("matrix_nms", b, s, 0.2, post_threshold=0.1,
                     nms_top_k=15, keep_top_k=20, use_gaussian=gaussian)
    assert_close(ref, port, exact=True)


# -- RoI ----------------------------------------------------------------------

def _rois():
    rng = np.random.RandomState(10)
    x = rng.rand(2, 8, 12, 10).astype(np.float32)
    boxes = np.array([[0, 0, 5, 5], [1.5, 2.2, 8.7, 9.1], [3, 1, 4, 2],
                      [2, 3, 9, 11], [0.2, 0.4, 3.3, 2.8]], np.float32)
    return x, boxes, np.array([2, 3], np.int32)


@pytest.mark.parametrize("kw", [dict(), dict(aligned=False),
                                dict(sampling_ratio=3, spatial_scale=0.5)])
def test_roi_align_matches_the_reference(kw):
    x, boxes, num = _rois()
    assert_close(*both("roi_align", x, boxes, num, 3, **kw))


def test_roi_align_gradient_reaches_x():
    x, boxes, num = _rois()
    xp = torch.from_numpy(x).requires_grad_(True)
    T.roi_align(xp, torch.from_numpy(boxes), torch.from_numpy(num),
                (2, 3)).sum().backward()
    assert np.abs(xp.grad.numpy()).sum() > 0


def test_roi_pool_and_prroi_pool_match_the_reference():
    x, boxes, num = _rois()
    assert_close(*both("roi_pool", x, boxes, num, (3, 2)))
    assert_close(*both("roi_pool", x, boxes, num, 2, spatial_scale=0.7))
    assert_close(*both("prroi_pool", x, boxes, num, 2))


def test_psroi_pool_matches_the_reference():
    # tests/test_op_families.py's case, then a seeded one
    rng = np.random.RandomState(0)
    x = rng.rand(1, 12, 8, 8).astype(np.float32)
    boxes = np.array([[0.0, 0.0, 4.0, 4.0], [2.0, 2.0, 7.0, 6.0]],
                     np.float32)
    assert_close(*both("psroi_pool", x, boxes, np.array([2], np.int32), 2))
    x, boxes, num = _rois()
    assert_close(*both("psroi_pool", np.concatenate([x] * 9, 1), boxes, num,
                       3, spatial_scale=0.8))


def test_generate_proposals_matches_the_reference():
    # tests/test_op_families.py's TestGenerateProposals inputs
    rng = np.random.RandomState(2)
    N, A, H, W = 1, 3, 4, 4
    scores = rng.rand(N, A, H, W).astype(np.float32)
    deltas = (rng.rand(N, 4 * A, H, W).astype(np.float32) - 0.5) * 0.2
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    anchors = np.stack([xs * 4, ys * 4, xs * 4 + 8, ys * 4 + 8],
                       axis=-1).astype(np.float32)
    anchors = np.repeat(anchors[:, :, None, :], A, axis=2)
    variances = np.ones_like(anchors)
    ref, port = both("generate_proposals", scores, deltas,
                     np.array([[16.0, 16.0]], np.float32), anchors,
                     variances, pre_nms_top_n=20, post_nms_top_n=5,
                     nms_thresh=0.7, min_size=1.0, return_rois_num=True)
    assert_close(ref, port, exact=True)
    scores2 = rng.rand(2, A, H, W).astype(np.float32)
    deltas2 = (rng.rand(2, 4 * A, H, W).astype(np.float32) - 0.5) * 0.5
    ref, port = both("generate_proposals", scores2, deltas2,
                     np.array([[16.0, 16.0], [12.0, 15.0]], np.float32),
                     anchors, variances * 0.5, pre_nms_top_n=30,
                     post_nms_top_n=8, nms_thresh=0.5, min_size=0.5)
    assert_close(ref, port, exact=True)


def test_distribute_fpn_proposals_matches_the_reference():
    rng = np.random.RandomState(11)
    rois = _boxes(rng, 30, scale=400.0)
    for pixel_offset in (False, True):
        ref, port = both("distribute_fpn_proposals", rois, 2, 5, 4, 224,
                         pixel_offset=pixel_offset)
        assert_close(ref[0], port[0], exact=True)
        assert_close(ref[1], port[1], exact=True)


# -- targets and metrics ------------------------------------------------------

@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_matches_the_reference(match_type):
    rng = np.random.RandomState(12)
    dist = rng.rand(2, 4, 9).astype(np.float32)
    assert_close(*both("bipartite_match", dist, match_type, 0.3), exact=True)
    assert_close(*both("bipartite_match", dist[0], match_type, 0.3),
                 exact=True)


def test_target_assign_matches_the_reference():
    rng = np.random.RandomState(13)
    x = rng.rand(2, 4, 3).astype(np.float32)
    match = rng.randint(-1, 4, (2, 6)).astype(np.int64)
    neg = np.array([[0, 2, -1], [5, -1, -1]], np.int64)
    assert_close(*both("target_assign", x, match, mismatch_value=-2))
    assert_close(*both("target_assign", x, match, negative_indices=neg))
    assert_close(*both("target_assign", x[..., 0], match))


@pytest.mark.parametrize("use_random", [False, True])
def test_rpn_target_assign_matches_the_reference(use_random):
    rng = np.random.RandomState(14)
    anchors = _boxes(rng, 60, scale=50.0)
    gts = _boxes(rng, 4, scale=50.0)
    crowd = np.array([0, 0, 1, 0], np.int32)
    ref, port = both("rpn_target_assign", anchors, gts, crowd,
                     rpn_batch_size_per_im=16, use_random=use_random,
                     seed=3)
    assert_close(ref, port, exact=True)


def test_mine_hard_examples_matches_the_reference():
    rng = np.random.RandomState(15)
    loss = rng.rand(3, 20).astype(np.float32)
    match = rng.randint(-1, 3, (3, 20)).astype(np.int64)
    match[2] = -1
    assert_close(*both("mine_hard_examples", loss, match), exact=True)
    assert_close(*both("mine_hard_examples", loss, match, sample_size=4),
                 exact=True)
    with pytest.raises(NotImplementedError):
        T.mine_hard_examples(torch.from_numpy(loss), torch.from_numpy(match),
                             mining_type="hard_example")


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
@pytest.mark.parametrize("difficult", [True, False])
def test_detection_map_matches_the_reference(ap_version, difficult):
    rng = np.random.RandomState(16)
    gt = np.concatenate([rng.randint(0, 2, (12, 1)), rng.randint(1, 4, (12, 1)),
                         rng.rand(12, 1) < 0.3, _boxes(rng, 12)],
                        1).astype(np.float32)
    det = np.concatenate([rng.randint(0, 2, (30, 1)),
                          rng.randint(1, 4, (30, 1)), rng.rand(30, 1),
                          _boxes(rng, 30)], 1).astype(np.float32)
    ref, port = both("detection_map", det, gt, 4, evaluate_difficult=difficult,
                     ap_version=ap_version)
    assert_close(ref, port, exact=True)


def test_every_reference_op_is_ported():
    import inspect
    names = sorted(n for n, f in vars(R).items() if inspect.isfunction(f)
                   and f.__module__ == R.__name__ and not n.startswith("_"))
    assert len(names) == 22
    assert [n for n in names if not callable(getattr(T, n, None))] == []
    assert sorted(T.__all__) == names


# -- config 5's step, at the reference's CPU size -----------------------------

SIZES, BATCH = (64, 96), 2
C5_ANCHORS, C5_MASK, C5_CLASSES = [116, 90, 156, 198, 373, 326], [0, 1, 2], 80


def _c5_batches():
    """bench_detection's batches at its CPU size (one RandomState(0), in
    size order)."""
    rng = np.random.RandomState(0)
    out = {}
    for size in SIZES:
        img = rng.rand(BATCH, 3, size, size).astype("float32")
        gtb = np.zeros((BATCH, 50, 4), np.float32)
        for i in range(BATCH):
            k = rng.randint(1, 20)
            cxy = rng.rand(k, 2) * 0.8 + 0.1
            wh = rng.rand(k, 2) * 0.2 + 0.05
            gtb[i, :k] = np.concatenate([cxy, wh], 1)
        gtl = rng.randint(0, C5_CLASSES, (BATCH, 50)).astype("int64")
        out[size] = (img, gtb, gtl)
    return out


def _c5_steps(side, backbone, head, opt, loss_fn, jit):
    """{amp: the side's to_static train step} over the same objects."""
    def make(amp):
        def train_step(img, gtb, gtl):
            with side.amp.auto_cast(enable=amp, dtype="bfloat16"):
                loss = loss_fn(head(backbone(img)), gtb, gtl, C5_ANCHORS,
                               C5_MASK, C5_CLASSES, ignore_thresh=0.7,
                               downsample_ratio=32).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return jit.to_static(train_step)
    return {amp: make(amp) for amp in (True, False)}


def _flat(params):
    return np.concatenate([np.asarray(
        p.detach().numpy() if isinstance(p, torch.Tensor) else p.numpy(),
        np.float64).ravel() for p in params])


@pytest.fixture(scope="module")
def config5():
    """Each step of the reference's bf16 run, from its state before it: the
    loss and the update of both sides in bf16 and in float32 (the reference
    continues from its bf16 step)."""
    import paddle_tpu.nn as rnn
    from paddle_tpu.vision.models import resnet18 as ref_resnet18
    from paddle_tpu_torch import jit, nn, optimizer
    from paddle_tpu_torch.bridge import load_reference_state
    from paddle_tpu_torch.vision.models import resnet18
    paddle.seed(0)
    rb = ref_resnet18(num_classes=0, with_pool=False)
    rh = rnn.Conv2D(512, len(C5_MASK) * (5 + C5_CLASSES), 1)
    ref_params = rb.parameters() + rh.parameters()
    ropt = paddle.optimizer.Momentum(parameters=ref_params,
                                     learning_rate=0.01, momentum=0.9)
    rsteps = _c5_steps(paddle, rb, rh, ropt, R.yolov3_loss, paddle.jit)
    backbone = resnet18(num_classes=0, with_pool=False, device="cpu")
    head = nn.Conv2D(512, len(C5_MASK) * (5 + C5_CLASSES), 1, device="cpu")
    params = backbone.parameters() + head.parameters()
    assert isinstance(params, list) and len(params) == len(ref_params)
    opt = optimizer.Momentum(parameters=params, learning_rate=0.01,
                             momentum=0.9)
    steps = _c5_steps(pt, backbone, head, opt, T.yolov3_loss, jit)

    def velocity(p):
        return ropt._accumulators[("velocity", id(p))]

    def ref_state():
        return ({n: np.asarray(t.numpy()).copy()
                 for n, t in list(rb.state_dict().items())
                 + [("head." + n, t) for n, t in rh.state_dict().items()]},
                [np.asarray(velocity(p)._value).copy() for p in ref_params])

    def set_ref(state):
        tensors, vel = state
        for n, t in list(rb.state_dict().items()) + [
                ("head." + n, t) for n, t in rh.state_dict().items()]:
            t.set_value(tensors[n])
        for p, v in zip(ref_params, vel):
            velocity(p)._value = paddle.to_tensor(v)._value

    def set_port(state):
        tensors, vel = state
        load_reference_state(backbone, {n: v for n, v in tensors.items()
                                        if not n.startswith("head.")})
        load_reference_state(head, {n[5:]: v for n, v in tensors.items()
                                    if n.startswith("head.")})
        with torch.no_grad():
            for p, v in zip(params, vel):
                opt._get_accumulator("velocity", p).copy_(
                    torch.from_numpy(v.copy()))

    data = _c5_batches()
    out = {True: [], False: []}
    for size in SIZES:
        state = ref_state()
        before = _flat(ref_params)
        rec = {}
        for amp in (False, True):  # the reference ends on its bf16 step
            set_ref(state)
            ref_loss = float(rsteps[amp](*map(paddle.to_tensor,
                                               data[size])).numpy())
            ref_update = _flat(ref_params) - before
            set_port(state)
            loss = steps[amp](*map(torch.from_numpy, data[size])).item()
            rec[amp] = (loss, ref_loss, _flat(params) - before, ref_update)
        for amp in (True, False):
            out[amp].append(rec[amp] + (rec[False][3],))
    return out


def test_config5_float32_steps_match_the_reference_to_static_step(config5):
    for loss, ref_loss, update, ref_update, _ in config5[False]:
        assert abs(loss - ref_loss) <= F32_LOSS_REL * abs(ref_loss)
        assert _rel(update, ref_update) <= F32_UPDATE_REL


def test_config5_bf16_steps_match_the_reference_to_static_step(config5):
    for loss, ref_loss, update, ref_update, f32_update in config5[True]:
        assert abs(loss - ref_loss) <= BF16_LOSS_REL * abs(ref_loss)
        ref_err = _rel(ref_update, f32_update)
        assert _rel(update, f32_update) <= BF16_UPDATE_FACTOR * ref_err
