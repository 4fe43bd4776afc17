"""The port's vision functionals (``nn.functional.vision``) and
``nn.LocalResponseNorm`` against the reference's, on the CPU.

Each case runs the same seeded float32 inputs through both packages: the
outputs within ``RTOL``/``ATOL`` and the gradients of ``sum(out * c)``
(``c`` seeded) with respect to every float input within ``GRAD_RTOL``/
``GRAD_ATOL`` (float32, the same math; ``deformable_conv`` and
``grid_sample`` sum over taps and corners in another order). The
reference's own cases (``tests/test_op_tail2.py``, ``TestSpatial``) are
here too, against their stated values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _theta(r, n):
    eye = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (n, 1, 1))
    return (eye + 0.2 * r.randn(n, 2, 3)).astype(np.float32)


def _grid(r, n, h, w, spread=1.3):
    return (spread * (2 * r.rand(n, h, w, 2) - 1)).astype(np.float32)


def _dc_inputs(r, v2, groups=1, dg=1, stride=1, padding=1):
    x = r.randn(2, 4, 7, 6).astype(np.float32)
    w = (0.3 * r.randn(6, 4 // groups, 3, 3)).astype(np.float32)
    ho = (7 + 2 * padding - 3) // stride + 1
    wo = (6 + 2 * padding - 3) // stride + 1
    off = (1.5 * r.randn(2, 2 * dg * 9, ho, wo)).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    args = [x, off, w, b]
    kw = {"stride": stride, "padding": padding, "deformable_groups": dg,
          "groups": groups}
    if v2:
        kw["mask"] = r.rand(2, dg * 9, ho, wo).astype(np.float32)
    return args, kw


# name: builder(r) -> (function name, positional args, keyword args); the
# float numpy arrays among them are differentiated
CASES = {
    "affine_grid_align": lambda r: ("affine_grid", [_theta(r, 2)],
                                    {"out_shape": [2, 3, 5, 4]}),
    "affine_grid_half": lambda r: ("affine_grid", [_theta(r, 2)],
                                   {"out_shape": [2, 3, 4, 6],
                                    "align_corners": False}),
    **{f"grid_sample_{mode}_{pad}_{ac}": (
        lambda r, mode=mode, pad=pad, ac=ac: (
            "grid_sample", [r.randn(2, 3, 5, 6).astype(np.float32),
                            _grid(r, 2, 4, 3)],
            {"mode": mode, "padding_mode": pad, "align_corners": ac}))
       for mode in ("bilinear", "nearest")
       for pad in ("zeros", "border", "reflection")
       for ac in (True, False)},
    "temporal_shift": lambda r: ("temporal_shift",
                                 [r.randn(6, 8, 3, 3).astype(np.float32)],
                                 {"seg_num": 3}),
    "temporal_shift_nhwc": lambda r: ("temporal_shift",
                                      [r.randn(4, 3, 3, 8).astype(
                                          np.float32)],
                                      {"seg_num": 2, "shift_ratio": 0.125,
                                       "data_format": "NHWC"}),
    "channel_shuffle": lambda r: ("channel_shuffle",
                                  [r.randn(2, 6, 3, 3).astype(np.float32)],
                                  {"groups": 3}),
    "channel_shuffle_nhwc": lambda r: ("channel_shuffle",
                                       [r.randn(2, 3, 3, 6).astype(
                                           np.float32)],
                                       {"groups": 2, "data_format": "NHWC"}),
    "space_to_depth": lambda r: ("space_to_depth",
                                 [r.randn(2, 3, 4, 6).astype(np.float32)],
                                 {"blocksize": 2}),
    "affine_channel": lambda r: ("affine_channel",
                                 [r.randn(2, 3, 4, 4).astype(np.float32),
                                  r.randn(3).astype(np.float32),
                                  r.randn(3).astype(np.float32)], {}),
    "affine_channel_nhwc": lambda r: ("affine_channel",
                                      [r.randn(2, 4, 4, 3).astype(
                                          np.float32),
                                       r.randn(3).astype(np.float32),
                                       r.randn(3).astype(np.float32)],
                                      {"data_format": "NHWC"}),
    "local_response_norm": lambda r: ("local_response_norm",
                                      [r.randn(2, 7, 3, 3).astype(
                                          np.float32)],
                                      {"size": 5, "alpha": 1e-2,
                                       "beta": 0.75, "k": 2.0}),
    "local_response_norm_even_nhwc": lambda r: (
        "local_response_norm", [r.randn(2, 3, 3, 6).astype(np.float32)],
        {"size": 4, "alpha": 0.1, "data_format": "NHWC"}),
    "lrn": lambda r: ("lrn", [r.randn(2, 6, 3, 3).astype(np.float32)],
                      {"n": 3, "alpha": 1e-2}),
    "deformable_conv_v1": lambda r: ("deformable_conv",
                                     *_dc_inputs(r, v2=False)),
    "deformable_conv_v2": lambda r: ("deformable_conv",
                                     *_dc_inputs(r, v2=True)),
    "deformable_conv_v2_groups": lambda r: (
        "deformable_conv", *_dc_inputs(r, v2=True, groups=2, dg=2,
                                       stride=2, padding=0)),
}


def _split_kw(name, args, kw):
    """deformable_conv's optional tensors (bias, mask) as keywords."""
    if name == "deformable_conv":
        x, off, w, b = args
        return [x, off, w], dict(kw, bias=b)
    return args, kw


def _run(pkg, case, grad):
    r = np.random.RandomState(sum(map(ord, case)))
    name, args, kw = CASES[case](r)
    args, kw = _split_kw(name, args, kw)

    def t(a):
        if pkg is paddle:
            return paddle.to_tensor(a, stop_gradient=not grad)
        return pt.to_tensor(a, place="cpu", stop_gradient=not grad)

    targs = [t(a) if isinstance(a, np.ndarray) else a for a in args]
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    fn = getattr(RF if pkg is paddle else F, name)
    out = fn(*targs, **tkw)
    ins = [a for a in targs + list(tkw.values())
           if not isinstance(a, (int, float, str, list, bool))]
    return out, ins


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_reference(case):
    want, _ = _run(paddle, case, grad=False)
    got, _ = _run(pt, case, grad=False)
    assert type(got) is pt.Tensor
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_matches_reference(case):
    grads = []
    for pkg in (paddle, pt):
        out, ins = _run(pkg, case, grad=True)
        c = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
        ct = paddle.to_tensor(c) if pkg is paddle else pt.to_tensor(
            c, place="cpu")
        grads.append(pkg.grad([(out * ct).sum()], ins, allow_unused=True))
    for i, (w, g) in enumerate(zip(*grads)):
        if w is None:
            assert g is None or not np.any(_np(g)), (case, i)
            continue
        np.testing.assert_allclose(_np(g), _np(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{case} d{i}")


def test_local_response_norm_layer_matches_reference():
    x = np.random.RandomState(4).randn(2, 6, 4, 4).astype(np.float32)
    want = paddle.nn.LocalResponseNorm(3, alpha=1e-2, k=1.5)(
        paddle.to_tensor(x))
    layer = pt.nn.LocalResponseNorm(3, alpha=1e-2, k=1.5)
    got = layer(pt.to_tensor(x, place="cpu"))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    assert list(layer.parameters()) == []


# -- the reference's own cases (tests/test_op_tail2.py, TestSpatial) ------------

rng = np.random.RandomState(7)


def t(a):
    return pt.to_tensor(np.asarray(a), place="cpu")


def test_affine_grid_sample_identity():
    x = t(rng.rand(2, 3, 4, 5).astype(np.float32))
    theta = t(np.tile(np.array([[[1.0, 0, 0], [0, 1.0, 0]]], np.float32),
                      (2, 1, 1)))
    g = F.affine_grid(theta, [2, 3, 4, 5])
    y = F.grid_sample(x, g)
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-3)


def test_grid_sample_padding_modes():
    x = t(np.arange(4, dtype=np.float32).reshape(1, 1, 2, 2))
    g = t(np.array([[[[-2.0, -2.0]]]], np.float32))  # out of range
    assert F.grid_sample(x, g, padding_mode="zeros").numpy().ravel()[0] == 0
    assert F.grid_sample(x, g, padding_mode="border").numpy().ravel()[0] == 0


def test_grid_sample_grad():
    x = t(rng.rand(1, 2, 3, 3).astype(np.float32))
    x.stop_gradient = False
    theta = t(np.array([[[0.8, 0, 0.1], [0, 0.8, -0.1]]], np.float32))
    F.grid_sample(x, F.affine_grid(theta, [1, 2, 3, 3])).sum().backward()
    assert x.grad is not None and np.isfinite(x.grad.numpy()).all()


def test_channel_ops():
    cs = F.channel_shuffle(
        t(np.arange(8, dtype=np.float32).reshape(1, 8, 1, 1)), 2)
    np.testing.assert_allclose(cs.numpy().ravel(), [0, 4, 1, 5, 2, 6, 3, 7])
    s2d = F.space_to_depth(
        t(np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)), 2)
    assert s2d.shape == [1, 4, 2, 2]
    x = t(rng.rand(2, 3, 4, 5).astype(np.float32))
    ac = F.affine_channel(x, t(np.full(3, 2.0, np.float32)),
                          t(np.ones(3, np.float32)))
    np.testing.assert_allclose(ac.numpy(), 2 * x.numpy() + 1, rtol=1e-6)
    ts = F.temporal_shift(t(rng.rand(4, 8, 2, 2).astype(np.float32)), 2)
    assert ts.shape == [4, 8, 2, 2]
    assert F.local_response_norm(x).shape == x.shape
    assert F.shuffle_channel is F.channel_shuffle


def test_deformable_conv_zero_offset_equals_conv():
    xx = rng.rand(1, 4, 6, 6).astype(np.float32)
    w = rng.rand(5, 4, 3, 3).astype(np.float32)
    off = np.zeros((1, 18, 4, 4), np.float32)
    dc = F.deformable_conv(t(xx), t(off), t(w))
    ref = torch.nn.functional.conv2d(torch.from_numpy(xx),
                                     torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(dc.numpy(), ref, rtol=1e-4, atol=1e-5)
    m = np.full((1, 9, 4, 4), 0.5, np.float32)
    dc2 = F.deformable_conv(t(xx), t(off), t(w), mask=t(m))
    np.testing.assert_allclose(dc2.numpy(), 0.5 * ref, rtol=1e-4, atol=1e-5)


def test_plain_tensors_stay_plain():
    x = torch.randn(2, 4, 3, 3)
    assert type(F.channel_shuffle(x, 2)) is torch.Tensor
