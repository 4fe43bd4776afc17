"""The nn layer library's functionals and layers against the reference's,
on the CPU: the activations, the common functionals and layers, the
containers, the losses, the norms, the initializers and the layer tail
(``nn/layer/extras.py``).

Each functional case runs the same seeded float32 inputs through both
packages: the outputs within ``RTOL``/``ATOL`` and the gradients of
``sum(out * c)`` (``c`` seeded) with respect to every float input within
``GRAD_RTOL``/``GRAD_ATOL`` (the same float32 math in another order).
Layers get the reference's weights through ``bridge.load_reference_state``
and are held to the same bounds. Under bf16 ``auto_cast`` each listed op
returns the reference's dtype and agrees within ``BF16_REL`` relative to
the largest element (both round to bf16 in the same places, and the sums
accumulate in another order).

The functionals that draw (``dropout2d``/``3d``, ``alpha_dropout``,
``gumbel_softmax``, ``nce``, ``sampled_softmax_with_cross_entropy``) are
held at the same draws (the reference's ``jax.random`` draw and the port's
``torch`` draw both replaced by one numpy sample) and their draws by their
moments. Initializers are held by the moments and bounds of 40,000 draws
(the packages' generators differ).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu.nn import initializer as RI
from paddle_tpu_torch import amp
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.nn import initializer as TI

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_REL = 2e-2
MOMENT_TOL = 0.03  # 40,000 draws: a moment's sampling error is ~0.005


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t.numpy()).astype(np.float32) if str(
        t.dtype) == "bfloat16" else np.asarray(t.numpy())


def _f(r, *shape, scale=1.0):
    return (scale * r.randn(*shape)).astype(np.float32)


def _i(r, high, *shape):
    return r.randint(0, high, shape).astype(np.int64)


def _u(r, *shape, lo=0.05, hi=0.95):
    return r.uniform(lo, hi, shape).astype(np.float32)


# -- functionals -----------------------------------------------------------
# name: maker(r) -> (function name, positional args, keyword args); the
# float numpy arrays among the positional and keyword args are
# differentiated

def _act(name, **kw):
    return lambda r: (name, [_f(r, 3, 4, 5, scale=2.0)], kw)


ACTIVATIONS = {
    "relu": _act("relu"), "relu6": lambda r: (
        "relu6", [_f(r, 3, 4, 5, scale=5.0)], {}),
    "sigmoid": _act("sigmoid"), "tanh": _act("tanh"),
    "gelu": _act("gelu"), "gelu_tanh": _act("gelu", approximate=True),
    "silu": _act("silu"), "swish": _act("swish"), "mish": _act("mish"),
    "leaky_relu": _act("leaky_relu", negative_slope=0.1),
    "elu": _act("elu", alpha=0.5), "selu": _act("selu"),
    "celu": _act("celu", alpha=0.7),
    "hardshrink": _act("hardshrink", threshold=0.3),
    "softshrink": _act("softshrink", threshold=0.3),
    "tanhshrink": _act("tanhshrink"),
    "hardtanh": _act("hardtanh", min=-0.5, max=0.7),
    "hardsigmoid": _act("hardsigmoid"), "hardswish": _act("hardswish"),
    "softplus": _act("softplus", beta=2.0, threshold=3.0),
    "softsign": _act("softsign"),
    "thresholded_relu": _act("thresholded_relu", threshold=0.4),
    "log_sigmoid": _act("log_sigmoid"),
    "softmax": _act("softmax", axis=1), "log_softmax": _act("log_softmax",
                                                            axis=0),
    "prelu_one": lambda r: ("prelu", [_f(r, 2, 3, 4, 4),
                                      np.array([0.2], np.float32)], {}),
    "prelu_channels": lambda r: ("prelu", [_f(r, 2, 3, 4, 4),
                                           _u(r, 3)], {}),
    "glu": _act("glu", axis=1), "maxout": lambda r: (
        "maxout", [_f(r, 2, 6, 3, 3)], {"groups": 3, "axis": 1}),
}

COMMON = {
    "one_hot": lambda r: ("one_hot", [np.array([[0, 3], [5, 2]])],
                          {"num_classes": 5}),
    "label_smooth": lambda r: ("label_smooth", [_u(r, 4, 7)],
                               {"epsilon": 0.2}),
    "label_smooth_prior": lambda r: (
        "label_smooth", [_u(r, 4, 7)],
        {"prior_dist": np.full((1, 7), 1 / 7, np.float32),
         "epsilon": 0.1}),
    "unfold": lambda r: ("unfold", [_f(r, 2, 3, 6, 7)],
                         {"kernel_sizes": [3, 2], "strides": [1, 2],
                          "paddings": [1, 0], "dilations": 1}),
    "unfold_dilated": lambda r: ("unfold", [_f(r, 1, 2, 7, 7)],
                                 {"kernel_sizes": 3, "dilations": 2,
                                  "paddings": 2}),
    "cosine_similarity": lambda r: ("cosine_similarity",
                                    [_f(r, 4, 6), _f(r, 4, 6)], {}),
    "cosine_similarity_axis": lambda r: ("cosine_similarity",
                                         [_f(r, 3, 5, 2), _f(r, 3, 5, 2)],
                                         {"axis": 2, "eps": 1e-6}),
    "bilinear": lambda r: ("bilinear", [_f(r, 3, 4), _f(r, 3, 5),
                                        _f(r, 6, 4, 5), _f(r, 6)], {}),
    "normalize_p2": lambda r: ("normalize", [_f(r, 3, 6)], {}),
    "normalize_p1_axis0": lambda r: ("normalize", [_f(r, 3, 6)],
                                     {"p": 1, "axis": 0}),
    "normalize_p3": lambda r: ("normalize", [_f(r, 2, 4, 3)], {"p": 3}),
    "pixel_shuffle": lambda r: ("pixel_shuffle", [_f(r, 2, 8, 3, 4)],
                                {"upscale_factor": 2}),
    **{f"interpolate_{mode}_{tag}": (
        lambda r, mode=mode, shape=shape, kw=kw: (
            "interpolate", [_f(r, *shape)], dict(kw, mode=mode)))
       for mode, shape, tag, kw in (
           ("nearest", (2, 3, 5, 6), "up", {"size": [8, 9]}),
           ("nearest", (2, 3, 9, 8), "down", {"size": [4, 5]}),
           ("nearest", (2, 3, 4, 5), "scale", {"scale_factor": 2}),
           ("bilinear", (2, 3, 5, 6), "up", {"size": [8, 11]}),
           ("bilinear", (2, 3, 9, 8), "down", {"size": [4, 3]}),
           ("bilinear", (2, 5, 6, 3), "nhwc",
            {"size": [7, 4], "data_format": "NHWC"}),
           ("bilinear", (2, 3, 5, 6), "align",
            {"size": [8, 4], "align_corners": True}),
           ("bicubic", (2, 3, 5, 6), "up", {"size": [9, 10]}),
           ("bicubic", (2, 3, 10, 9), "down", {"size": [4, 6]}),
           ("linear", (2, 3, 7), "up", {"size": [12],
                                        "data_format": "NCW"}),
           ("linear", (2, 3, 7), "align", {"size": [4],
                                           "data_format": "NCW",
                                           "align_corners": True}),
           ("trilinear", (1, 2, 3, 4, 5), "up",
            {"size": [5, 6, 3], "data_format": "NCDHW"}),
           ("area", (2, 3, 8, 8), "down", {"size": [3, 5]}))},
    "upsample": lambda r: ("upsample", [_f(r, 2, 3, 4, 4)],
                           {"scale_factor": 2, "mode": "bilinear"}),
}

LOSSES = {
    "cross_entropy_hard": lambda r: ("cross_entropy",
                                     [_f(r, 6, 7), _i(r, 7, 6)], {}),
    "cross_entropy_hard_weight_ignore": lambda r: (
        "cross_entropy", [_f(r, 6, 7), np.array([1, 3, -100, 6, 0, 3])],
        {"weight": _u(r, 7), "ignore_index": -100}),
    "cross_entropy_hard_sum_axis1": lambda r: (
        "cross_entropy", [_f(r, 3, 5, 4), _i(r, 5, 3, 1, 4)],
        {"axis": 1, "reduction": "sum"}),
    "cross_entropy_soft": lambda r: (
        "cross_entropy", [_f(r, 6, 7), np.float32(
            np.random.RandomState(3).dirichlet(np.ones(7), 6))],
        {"soft_label": True}),
    "cross_entropy_soft_smoothing_none": lambda r: (
        "cross_entropy", [_f(r, 2, 3, 7), np.float32(
            np.random.RandomState(4).dirichlet(np.ones(7), (2, 3)))],
        {"soft_label": True, "label_smoothing": 0.1, "reduction": "none"}),
    "cross_entropy_hard_smoothing": lambda r: (
        "cross_entropy", [_f(r, 6, 7), np.array([1, 3, -100, 6, 0, 3])],
        {"label_smoothing": 0.1}),
    "cross_entropy_hard_smoothing_weight": lambda r: (
        "cross_entropy", [_f(r, 6, 7), _i(r, 7, 6)],
        {"label_smoothing": 0.2, "weight": _u(r, 7),
         "reduction": "none"}),
    "cross_entropy_probabilities": lambda r: (
        "cross_entropy", [np.float32(np.random.RandomState(5).dirichlet(
            np.ones(7), 6)), _i(r, 7, 6)], {"use_softmax": False}),
    "cross_entropy_probabilities_soft": lambda r: (
        "cross_entropy", [np.float32(np.random.RandomState(6).dirichlet(
            np.ones(5), 4)), np.float32(np.random.RandomState(7).dirichlet(
                np.ones(5), 4))],
        {"use_softmax": False, "soft_label": True, "reduction": "sum"}),
    "softmax_with_cross_entropy": lambda r: (
        "softmax_with_cross_entropy", [_f(r, 5, 6), _i(r, 6, 5, 1)], {}),
    "softmax_with_cross_entropy_soft": lambda r: (
        "softmax_with_cross_entropy", [_f(r, 5, 6), np.float32(
            np.random.RandomState(8).dirichlet(np.ones(6), 5))],
        {"soft_label": True}),
    "nll_loss": lambda r: ("nll_loss", [_f(r, 6, 5), _i(r, 5, 6)], {}),
    "nll_loss_weight_ignore": lambda r: (
        "nll_loss", [_f(r, 6, 5), np.array([0, 4, 2, 1, 1, 3])],
        {"weight": _u(r, 5), "ignore_index": 1}),
    "nll_loss_sum": lambda r: ("nll_loss", [_f(r, 6, 5), _i(r, 5, 6)],
                               {"reduction": "sum"}),
    "mse_loss": lambda r: ("mse_loss", [_f(r, 4, 5), _f(r, 4, 5)], {}),
    "mse_loss_none": lambda r: ("mse_loss", [_f(r, 4, 5), _f(r, 4, 5)],
                                {"reduction": "none"}),
    "l1_loss": lambda r: ("l1_loss", [_f(r, 4, 5), _f(r, 4, 5)],
                          {"reduction": "sum"}),
    "smooth_l1_loss": lambda r: ("smooth_l1_loss", [_f(r, 4, 5),
                                                    _f(r, 4, 5)],
                                 {"delta": 0.7}),
    "binary_cross_entropy": lambda r: ("binary_cross_entropy",
                                       [_u(r, 4, 5), _u(r, 4, 5)],
                                       {"weight": _u(r, 5)}),
    "binary_cross_entropy_with_logits": lambda r: (
        "binary_cross_entropy_with_logits", [_f(r, 4, 5), _u(r, 4, 5)],
        {"pos_weight": _u(r, 5), "reduction": "sum"}),
    "kl_div": lambda r: ("kl_div", [np.log(_u(r, 4, 5)), _u(r, 4, 5)], {}),
    "kl_div_batchmean": lambda r: ("kl_div", [np.log(_u(r, 4, 5)),
                                              _u(r, 4, 5)],
                                   {"reduction": "batchmean"}),
    "margin_ranking_loss": lambda r: (
        "margin_ranking_loss", [_f(r, 6), _f(r, 6),
                                np.float32(r.choice([-1, 1], 6))],
        {"margin": 0.3}),
    "hinge_embedding_loss": lambda r: (
        "hinge_embedding_loss", [_f(r, 6), np.float32(r.choice([-1, 1], 6))],
        {"margin": 0.5}),
    "cosine_embedding_loss": lambda r: (
        "cosine_embedding_loss", [_f(r, 5, 4), _f(r, 5, 4),
                                  np.array([1, -1, 1, -1, -1])],
        {"margin": 0.1}),
    "triplet_margin_loss": lambda r: (
        "triplet_margin_loss", [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)],
        {"margin": 0.5, "p": 2.0}),
    "triplet_margin_loss_p1": lambda r: (
        "triplet_margin_loss", [_f(r, 5, 4), _f(r, 5, 4), _f(r, 5, 4)],
        {"p": 1.0, "reduction": "none"}),
    "square_error_cost": lambda r: ("square_error_cost",
                                    [_f(r, 4, 3), _f(r, 4, 3)], {}),
    "sigmoid_focal_loss": lambda r: (
        "sigmoid_focal_loss", [_f(r, 6, 3), np.float32(r.rand(6, 3) > 0.5)],
        {"normalizer": np.array([4.0], np.float32)}),
    "ctc_loss": lambda r: (
        "ctc_loss", [_f(r, 7, 3, 5), np.array([[1, 2, 2], [3, 1, 0],
                                               [4, 4, 4]]),
                     np.array([7, 5, 7]), np.array([3, 2, 3])], {}),
    "ctc_loss_sum_norm_by_times": lambda r: (
        "ctc_loss", [_f(r, 6, 2, 4), np.array([[1, 3], [2, 0]]),
                     np.array([6, 4]), np.array([2, 1])],
        {"reduction": "sum", "norm_by_times": True, "blank": 0}),
    "rank_loss": lambda r: ("rank_loss", [np.float32(r.rand(5, 1) > 0.5),
                                          _f(r, 5, 1), _f(r, 5, 1)], {}),
    "margin_rank_loss": lambda r: (
        "margin_rank_loss", [np.float32(r.choice([-1, 1], (5, 1))),
                             _f(r, 5, 1), _f(r, 5, 1)], {"margin": 0.2}),
    "huber_loss": lambda r: ("huber_loss", [_f(r, 6, 1), _f(r, 6, 1)],
                             {"delta": 0.5}),
    "log_loss": lambda r: ("log_loss", [_u(r, 6, 1),
                                        np.float32(r.rand(6, 1) > 0.5)], {}),
    "bpr_loss": lambda r: ("bpr_loss", [_f(r, 4, 5), _i(r, 5, 4, 1)], {}),
    "npair_loss": lambda r: ("npair_loss", [_f(r, 6, 4), _f(r, 6, 4),
                                            np.array([0, 1, 0, 2, 1, 2])],
                             {"l2_reg": 0.01}),
    "hsigmoid_loss": lambda r: ("hsigmoid_loss",
                                [_f(r, 5, 4), _i(r, 6, 5, 1), 6,
                                 _f(r, 5, 4), _f(r, 5)], {}),
    "hsigmoid_loss_custom_tree": lambda r: (
        "hsigmoid_loss", [_f(r, 3, 4), np.array([[0], [1], [2]]), 4,
                          _f(r, 3, 4)],
        {"path_table": np.array([[0, 1, -1], [0, 2, -1], [0, 1, 2]]),
         "path_code": np.array([[1, 0, 0], [0, 1, 0], [1, 1, 0]])}),
    "teacher_student_sigmoid_loss": lambda r: (
        "teacher_student_sigmoid_loss",
        [_f(r, 8, 1, scale=3.0), np.array([[-2.0], [-0.5], [0.3], [0.7],
                                           [1.2], [1.9], [-1.5], [0.0]],
                                          np.float32)], {}),
    "hinge_loss": lambda r: ("hinge_loss", [_f(r, 6, 1),
                                            np.float32(r.rand(6, 1) > 0.5)],
                             {}),
}

NORMS = {
    "rms_norm": lambda r: ("rms_norm", [_f(r, 3, 4, 8), _u(r, 8)], {}),
    "rms_norm_eps": lambda r: ("rms_norm", [_f(r, 3, 8)],
                               {"epsilon": 1e-3}),
    "instance_norm": lambda r: ("instance_norm", [_f(r, 2, 3, 4, 5),
                                                  _u(r, 3), _f(r, 3)], {}),
    "instance_norm_1d": lambda r: ("instance_norm", [_f(r, 2, 3, 6)], {}),
    "group_norm": lambda r: ("group_norm", [_f(r, 2, 6, 3, 3), 3,
                                            _u(r, 6), _f(r, 6)], {}),
    "group_norm_3d": lambda r: ("group_norm", [_f(r, 2, 4, 2, 3, 3), 2],
                                {"epsilon": 1e-3}),
}

CASES = {**ACTIVATIONS, **COMMON, **LOSSES, **NORMS}


def _tensor(pkg, a, grad):
    diff = grad and isinstance(a, np.ndarray) and a.dtype == np.float32
    if pkg is paddle:
        return paddle.to_tensor(a, stop_gradient=not diff), diff
    return pt.to_tensor(a, place="cpu", stop_gradient=not diff), diff


def _run(pkg, case, grad):
    r = np.random.RandomState(sum(map(ord, case)))
    name, args, kw = CASES[case](r)
    diff = []

    def t(a):
        if not isinstance(a, np.ndarray):
            return a
        v, d = _tensor(pkg, a, grad)
        if d:
            diff.append(v)
        return v

    targs = [t(a) for a in args]
    tkw = {k: t(v) for k, v in kw.items()}
    out = getattr(RF if pkg is paddle else F, name)(*targs, **tkw)
    return out, diff


@pytest.mark.parametrize("case", sorted(CASES))
def test_functional_forward_matches_reference(case):
    want, _ = _run(paddle, case, grad=False)
    got, _ = _run(pt, case, grad=False)
    assert type(got) is pt.Tensor
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


GRAD_CASES = sorted(c for c in CASES if c not in ("one_hot",))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_functional_gradient_matches_reference(case):
    grads = []
    for pkg in (paddle, pt):
        out, ins = _run(pkg, case, grad=True)
        c = np.asarray(np.random.RandomState(1).randn(*out.shape), np.float32)
        ct = paddle.to_tensor(c) if pkg is paddle else pt.to_tensor(
            c, place="cpu")
        grads.append(pkg.grad([(out * ct).sum()], ins, allow_unused=True))
    assert grads[1], case
    for i, (w, g) in enumerate(zip(*grads)):
        if w is None or g is None:  # a label: no gradient on either side
            other = g if w is None else w
            assert other is None or not np.any(_np(other)), (case, i)
            continue
        np.testing.assert_allclose(_np(g), _np(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{case} d{i}")


def test_every_new_functional_is_a_case():
    names = {CASES[c](np.random.RandomState(0))[0] for c in CASES}
    for module in (F.activation, F.common, F.loss):
        left = set(module.__all__) - names - {
            "linear", "embedding", "dropout", "dropout2d", "dropout3d",
            "alpha_dropout", "gumbel_softmax", "nce",
            "sampled_softmax_with_cross_entropy", "center_loss"}
        assert left == set(), module.__name__
    assert {"rms_norm", "instance_norm", "group_norm"} <= names


AMP_CASES = ["softmax", "log_softmax", "relu", "gelu", "sigmoid",
             "mse_loss", "kl_div", "binary_cross_entropy_with_logits",
             "cross_entropy_hard", "cross_entropy_soft", "rms_norm",
             "instance_norm", "group_norm", "interpolate_bilinear_up",
             "bilinear", "normalize_p2"]


@pytest.mark.parametrize("case", AMP_CASES)
def test_bf16_auto_cast_gives_the_reference_dtype(case):
    """A bf16 first input under ``auto_cast``: the reference's output
    dtype (float32 for block-listed losses, bf16 back from the downcast
    list), and its values within the bf16 bound."""
    outs = []
    for pkg, ctx in ((paddle, paddle.amp.auto_cast), (pt, amp.auto_cast)):
        r = np.random.RandomState(sum(map(ord, case)))
        name, args, kw = CASES[case](r)
        targs = [_tensor(pkg, a, False)[0] if isinstance(a, np.ndarray)
                 else a for a in args]
        tkw = {k: _tensor(pkg, v, False)[0] if isinstance(v, np.ndarray)
               else v for k, v in kw.items()}
        targs[0] = targs[0].astype("bfloat16")
        with ctx(dtype="bfloat16"):
            outs.append(getattr(RF if pkg is paddle else F, name)(
                *targs, **tkw))
    want, got = outs
    assert str(got.dtype).replace("torch.", "") == str(want.dtype).replace(
        "paddle.", ""), (got.dtype, want.dtype)
    w, g = _np(want), _np(got)
    assert np.abs(g - w).max() <= BF16_REL * max(np.abs(w).max(), 1e-6)


# -- the functionals that draw -------------------------------------------------

def _moments(x):
    return float(x.mean()), float(x.std())


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC", "NCDHW"])
def test_channel_dropout_matches_reference_at_the_same_mask(fmt,
                                                           monkeypatch):
    import jax
    r = np.random.RandomState(5)
    shape = {"NCHW": (3, 4, 2, 5), "NHWC": (3, 2, 5, 4),
             "NCDHW": (2, 3, 2, 3, 2)}[fmt]
    x = _f(r, *shape)
    axes = [0, 1] if fmt[1] == "C" else [0, len(shape) - 1]
    mshape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = r.rand(*mshape) >= 0.4
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, s: jax.numpy.asarray(keep))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(
        keep.astype(np.float32)))
    fn = "dropout3d" if fmt == "NCDHW" else "dropout2d"
    want = getattr(RF, fn)(paddle.to_tensor(x), p=0.4, data_format=fmt)
    got = getattr(F, fn)(pt.to_tensor(x, place="cpu"), p=0.4,
                         data_format=fmt)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_channel_dropout_draw():
    x = torch.ones(200, 200, 2, 3)
    y = F.dropout2d(x, p=0.3).numpy()
    per_channel = y.reshape(200, 200, -1)
    assert (per_channel.min(-1) == per_channel.max(-1)).all()
    dropped = float((per_channel[..., 0] == 0).mean())
    assert abs(dropped - 0.3) < MOMENT_TOL
    assert np.allclose(per_channel[per_channel > 0], 1 / 0.7)
    assert F.dropout2d(x, p=0.3, training=False) is x


def test_alpha_dropout_matches_reference_at_the_same_mask(monkeypatch):
    import jax
    r = np.random.RandomState(6)
    x = _f(r, 4, 6)
    keep = r.rand(4, 6) >= 0.25
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, s: jax.numpy.asarray(keep))
    want = RF.alpha_dropout(paddle.to_tensor(x), p=0.25)
    got = F.common.alpha_dropout_from_mask(torch.from_numpy(x),
                                           torch.from_numpy(keep), 0.25)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_alpha_dropout_keeps_the_moments():
    x = torch.randn(400, 400, generator=torch.Generator().manual_seed(0))
    y = F.alpha_dropout(x, p=0.2)
    mean, std = _moments(y.numpy())
    assert abs(mean) < MOMENT_TOL and abs(std - 1.0) < MOMENT_TOL
    assert F.alpha_dropout(x, p=0.2, training=False) is x


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_reference_at_the_same_noise(hard,
                                                            monkeypatch):
    import jax
    r = np.random.RandomState(7)
    x, g = _f(r, 3, 6), _f(r, 3, 6)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, s, dtype: jax.numpy.asarray(g))
    xt = paddle.to_tensor(x, stop_gradient=False)
    want = RF.gumbel_softmax(xt, temperature=0.7, hard=hard, axis=-1)
    c = r.randn(3, 6).astype(np.float32)
    (wg,) = paddle.grad([(want * paddle.to_tensor(c)).sum()], [xt])
    xp = torch.from_numpy(x).requires_grad_(True)
    got = F.activation.gumbel_softmax_from_noise(
        xp, torch.from_numpy(g), temperature=0.7, hard=hard)
    (gg,) = torch.autograd.grad((got * torch.from_numpy(c)).sum(), [xp])
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(gg), _np(wg), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_gumbel_softmax_draw_is_standard_gumbel(monkeypatch):
    seen = {}
    real = F.activation.gumbel_softmax_from_noise

    def spy(x, g, *a):
        seen["g"] = g
        return real(x, g, *a)

    monkeypatch.setattr(F.activation, "gumbel_softmax_from_noise", spy)
    y = F.gumbel_softmax(torch.zeros(200, 200))
    mean, std = _moments(seen["g"].numpy())
    assert abs(mean - 0.5772157) < MOMENT_TOL
    assert abs(std - np.pi / np.sqrt(6)) < MOMENT_TOL
    assert torch.allclose(y.sum(-1), torch.ones(200))


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform", "custom"])
def test_nce_matches_reference_at_the_same_samples(sampler, monkeypatch):
    import jax
    r = np.random.RandomState(8)
    x, w, b = _f(r, 4, 3), _f(r, 9, 3), _f(r, 9)
    lab = np.array([[1], [5], [0], [8]])
    samples = np.array([2, 7, 2, 0, 5])
    dist = _u(r, 9)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jax.numpy.asarray(samples))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda *a, **k: jax.numpy.asarray(samples))
    monkeypatch.setattr(torch, "randint",
                        lambda *a, **k: torch.from_numpy(samples))
    monkeypatch.setattr(torch, "multinomial",
                        lambda *a, **k: torch.from_numpy(samples))
    kw = {"num_neg_samples": 5, "sampler": "uniform" if sampler == "custom"
          else sampler, "custom_dist": dist if sampler == "custom" else None}
    outs, grads = [], []
    for pkg, fn in ((paddle, RF.nce), (pt, F.nce)):
        ts = [_tensor(pkg, a, True)[0] for a in (x, w, b)]
        lt = _tensor(pkg, lab, False)[0]
        out = fn(ts[0], lt, ts[1], ts[2], **kw)
        outs.append(_np(out))
        grads.append([_np(g) for g in pkg.grad([out.sum()], ts)])
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    for g, w_ in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g, w_, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_nce_draws_the_uniform_sampler():
    x = torch.zeros(2, 3)
    w = torch.zeros(10, 3)
    seen = {}
    real = F.loss.nce_from_samples

    def spy(*a):
        seen["s"] = a[4]
        return real(*a)

    import paddle_tpu_torch.nn.functional.loss as L
    L.nce_from_samples, old = spy, L.nce_from_samples
    try:
        F.nce(x, torch.tensor([[1], [2]]), w, num_neg_samples=20000, seed=3)
    finally:
        L.nce_from_samples = old
    counts = np.bincount(seen["s"].numpy(), minlength=10) / 20000
    assert np.abs(counts - 0.1).max() < MOMENT_TOL


def test_sampled_softmax_matches_reference_at_the_same_samples(monkeypatch):
    import jax
    r = np.random.RandomState(9)
    logits = _f(r, 4, 12)
    lab = np.array([[3], [0], [7], [11]])
    samples = np.array([1, 7, 5, 3, 9, 1])
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jax.numpy.asarray(samples))
    monkeypatch.setattr(torch, "randint",
                        lambda *a, **k: torch.from_numpy(samples))
    outs, grads = [], []
    for pkg, fn in ((paddle, RF.sampled_softmax_with_cross_entropy),
                    (pt, F.sampled_softmax_with_cross_entropy)):
        lt, _ = _tensor(pkg, logits, True)
        out = fn(lt, _tensor(pkg, lab, False)[0], num_samples=6, seed=1)
        outs.append(_np(out))
        grads.append(_np(pkg.grad([out.sum()], [lt])[0]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[1], grads[0], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_center_loss_matches_reference_and_moves_the_centers():
    r = np.random.RandomState(10)
    x, c0 = _f(r, 6, 3), _f(r, 4, 3)
    lab = np.array([0, 2, 2, 3, 0, 0])
    rc = paddle.to_tensor(c0.copy())
    want = RF.center_loss(paddle.to_tensor(x), paddle.to_tensor(lab), 4, 0.3,
                          rc)
    tc = torch.from_numpy(c0.copy())
    got = F.center_loss(torch.from_numpy(x), torch.from_numpy(lab), 4, 0.3,
                        tc)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), _np(rc), rtol=RTOL, atol=ATOL)
    assert not np.allclose(tc.numpy(), c0)


# -- layers ----------------------------------------------------------------------
# name: (maker(nn) -> layer, input shapes (float) or arrays); the port's
# layers with parameters are built on the CPU

def _dev(nn):
    return {} if nn is rnn else {"device": "cpu"}


LAYERS = {
    "ReLU": (lambda nn: nn.ReLU(), [(3, 5)]),
    "ReLU6": (lambda nn: nn.ReLU6(), [(3, 5)]),
    "Sigmoid": (lambda nn: nn.Sigmoid(), [(3, 5)]),
    "Tanh": (lambda nn: nn.Tanh(), [(3, 5)]),
    "GELU": (lambda nn: nn.GELU(approximate=True), [(3, 5)]),
    "Silu": (lambda nn: nn.Silu(), [(3, 5)]),
    "Swish": (lambda nn: nn.Swish(), [(3, 5)]),
    "Mish": (lambda nn: nn.Mish(), [(3, 5)]),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.2), [(3, 5)]),
    "ELU": (lambda nn: nn.ELU(0.4), [(3, 5)]),
    "SELU": (lambda nn: nn.SELU(), [(3, 5)]),
    "Hardtanh": (lambda nn: nn.Hardtanh(-0.3, 0.4), [(3, 5)]),
    "Hardsigmoid": (lambda nn: nn.Hardsigmoid(), [(3, 5)]),
    "Hardswish": (lambda nn: nn.Hardswish(), [(3, 5)]),
    "Softplus": (lambda nn: nn.Softplus(1.5, 2.0), [(3, 5)]),
    "Softshrink": (lambda nn: nn.Softshrink(0.2), [(3, 5)]),
    "Hardshrink": (lambda nn: nn.Hardshrink(0.2), [(3, 5)]),
    "Tanhshrink": (lambda nn: nn.Tanhshrink(), [(3, 5)]),
    "Softsign": (lambda nn: nn.Softsign(), [(3, 5)]),
    "LogSigmoid": (lambda nn: nn.LogSigmoid(), [(3, 5)]),
    "Softmax": (lambda nn: nn.Softmax(axis=0), [(3, 5)]),
    "LogSoftmax": (lambda nn: nn.LogSoftmax(), [(3, 5)]),
    "PReLU": (lambda nn: nn.PReLU(3, init=0.1, **_dev(nn)), [(2, 3, 4)]),
    "Maxout": (lambda nn: nn.Maxout(2), [(2, 4, 3)]),
    "ThresholdedReLU": (lambda nn: nn.ThresholdedReLU(0.3), [(3, 5)]),
    "Dropout2D_eval": (lambda nn: nn.Dropout2D(0.5).eval(), [(2, 3, 4, 4)]),
    "Flatten": (lambda nn: nn.Flatten(), [(2, 3, 4)]),
    "Identity": (lambda nn: nn.Identity(), [(2, 3)]),
    "Upsample": (lambda nn: nn.Upsample(size=[5, 7], mode="bilinear"),
                 [(2, 3, 4, 4)]),
    "Pad1D": (lambda nn: nn.Pad1D([1, 2], mode="reflect"), [(2, 3, 5)]),
    "Pad2D": (lambda nn: nn.Pad2D([1, 0, 2, 1], value=0.5),
              [(2, 3, 4, 4)]),
    "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=1),
                         [(3, 6), (3, 6)]),
    "Bilinear": (lambda nn: nn.Bilinear(3, 4, 5, **_dev(nn)),
                 [(2, 3), (2, 4)]),
    "PixelShuffle": (lambda nn: nn.PixelShuffle(3), [(1, 9, 2, 2)]),
    "RMSNorm": (lambda nn: nn.RMSNorm(6, **_dev(nn)), [(2, 3, 6)]),
    "GroupNorm": (lambda nn: nn.GroupNorm(2, 4, **_dev(nn)),
                  [(2, 4, 3, 3)]),
    "InstanceNorm1D": (lambda nn: nn.InstanceNorm1D(3, **_dev(nn)),
                       [(2, 3, 7)]),
    "InstanceNorm2D": (lambda nn: nn.InstanceNorm2D(3, **_dev(nn)),
                       [(2, 3, 4, 5)]),
    "InstanceNorm3D": (lambda nn: nn.InstanceNorm3D(2, **_dev(nn)),
                       [(2, 2, 3, 3, 2)]),
    "CrossEntropyLoss": (lambda nn: nn.CrossEntropyLoss(
        label_smoothing=0.1), [(5, 4), np.array([0, 3, 1, 1, 2])]),
    "MSELoss": (lambda nn: nn.MSELoss(), [(4, 3), (4, 3)]),
    "L1Loss": (lambda nn: nn.L1Loss(reduction="sum"), [(4, 3), (4, 3)]),
    "NLLLoss": (lambda nn: nn.NLLLoss(ignore_index=2),
                [(5, 4), np.array([0, 3, 2, 1, 2])]),
    "BCELoss": (lambda nn: nn.BCELoss(), [
        np.float32([[0.2, 0.7], [0.4, 0.9]]),
        np.float32([[0.0, 1.0], [1.0, 0.5]])]),
    "BCEWithLogitsLoss": (lambda nn: nn.BCEWithLogitsLoss(),
                          [(3, 4), np.float32(np.eye(3, 4))]),
    "KLDivLoss": (lambda nn: nn.KLDivLoss(reduction="sum"), [
        np.float32(np.log([[0.2, 0.8], [0.6, 0.4]])),
        np.float32([[0.3, 0.7], [0.5, 0.5]])]),
    "SmoothL1Loss": (lambda nn: nn.SmoothL1Loss(delta=0.5), [(4, 3),
                                                             (4, 3)]),
    "MarginRankingLoss": (lambda nn: nn.MarginRankingLoss(0.1), [
        (5,), (5,), np.float32([1, -1, 1, 1, -1])]),
    "Unfold": (lambda nn: nn.Unfold([2, 2], strides=2), [(2, 3, 4, 4)]),
    "AlphaDropout_eval": (lambda nn: nn.AlphaDropout(0.3).eval(),
                          [(3, 4)]),
    "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(
        scale_factor=2), [(1, 2, 3, 3)]),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(
        size=[5, 4]), [(1, 2, 3, 3)]),
    "CTCLoss": (lambda nn: nn.CTCLoss(), [
        (5, 2, 4), np.array([[1, 2], [3, 3]]), np.array([5, 4]),
        np.array([2, 2])]),
    "CosineEmbeddingLoss": (lambda nn: nn.CosineEmbeddingLoss(0.2), [
        (4, 3), (4, 3), np.array([1, -1, -1, 1])]),
    "TripletMarginLoss": (lambda nn: nn.TripletMarginLoss(margin=0.3),
                          [(4, 3), (4, 3), (4, 3)]),
}


def _layer_inputs(case):
    r = np.random.RandomState(sum(map(ord, case)))
    return [_f(r, *s) if isinstance(s, tuple) else s
            for s in LAYERS[case][1]]


def _layer_run(pkg, nn, case, layer, grad):
    ins = [_tensor(pkg, a, grad)[0] for a in _layer_inputs(case)]
    out = layer(*ins)
    return out, [t for t, a in zip(ins, _layer_inputs(case))
                 if grad and a.dtype == np.float32]


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_reference(case):
    build = LAYERS[case][0]
    ref, port = build(rnn), build(tnn)
    load_reference_state(port, {n: np.asarray(t.numpy())
                                for n, t in ref.state_dict().items()})
    want, wins = _layer_run(paddle, rnn, case, ref, True)
    got, gins = _layer_run(pt, tnn, case, port, True)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    c = np.asarray(np.random.RandomState(2).randn(*want.shape), np.float32)
    wg = paddle.grad([(want * paddle.to_tensor(c)).sum()],
                     wins + ref.parameters(), allow_unused=True)
    gg = pt.grad([(got * pt.to_tensor(c, place="cpu")).sum()],
                 gins + port.parameters(), allow_unused=True)
    for i, (w, g) in enumerate(zip(wg, gg)):
        if w is None or g is None:
            other = g if w is None else w
            assert other is None or not np.any(_np(other)), (case, i)
            continue
        np.testing.assert_allclose(_np(g), _np(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{case} d{i}")


def test_every_new_layer_is_a_case():
    from paddle_tpu_torch.nn.layer import activation, common, loss
    names = {c.split("_")[0] for c in LAYERS}
    for module in (activation, common, loss):
        classes = {n for n, v in vars(module).items()
                   if isinstance(v, type) and issubclass(v, tnn.Layer)
                   and v.__module__ == module.__name__}
        assert classes - names <= {"Linear", "Embedding", "Dropout"}, \
            module.__name__


def test_instance_norm_classes_are_one():
    assert tnn.InstanceNorm1D is tnn.InstanceNorm2D is tnn.InstanceNorm3D
    assert rnn.InstanceNorm1D is rnn.InstanceNorm3D


# -- containers --------------------------------------------------------------

def test_layer_dict_matches_reference_names():
    ref = rnn.LayerDict({"a": rnn.Linear(2, 3)})
    ref["b"] = rnn.Linear(3, 1)
    port = tnn.LayerDict({"a": tnn.Linear(2, 3, device="cpu")})
    port["b"] = tnn.Linear(3, 1, device="cpu")
    assert list(port.state_dict()) == list(ref.state_dict())
    assert list(port.keys()) == ["a", "b"] and len(port) == 2
    del port["a"]
    assert list(port) == ["b"] and list(port.state_dict()) == [
        "b.weight", "b.bias"]
    port.update([("c", tnn.ReLU())])
    assert [k for k, _ in port.items()] == ["b", "c"]


def test_parameter_list_matches_reference_names():
    w = np.ones((2, 2), np.float32)
    ref = rnn.ParameterList([paddle.Parameter(w), paddle.Parameter(w * 2)])
    port = tnn.ParameterList([pt.Parameter(torch.ones(2, 2)),
                              pt.Parameter(torch.ones(2, 2) * 2)])
    port.append(pt.Parameter(torch.zeros(1)))
    assert list(port.state_dict())[:2] == list(ref.state_dict())
    assert len(port) == 3 and torch.equal(port[1], torch.full((2, 2), 2.0))
    assert len(port.parameters()) == 3
    with pytest.raises(TypeError):
        port.append(torch.zeros(1))


# -- initializers -------------------------------------------------------------

# name: (maker(initializer module), shape, bounded: the extremes of a
# bounded draw sit at its bounds)
INITS = {
    "TruncatedNormal": (lambda I: I.TruncatedNormal(0.5, 2.0), (200, 200),
                        True),
    "Uniform": (lambda I: I.Uniform(-0.3, 0.7), (200, 200), True),
    "XavierUniform": (lambda I: I.XavierUniform(), (160, 250), True),
    "KaimingNormal": (lambda I: I.KaimingNormal(), (40, 10, 10, 10), False),
    "KaimingNormal_slope": (lambda I: I.KaimingNormal(
        negative_slope=0.2), (200, 200), False),
}


@pytest.mark.parametrize("case", sorted(INITS))
def test_initializer_draws_like_the_reference(case):
    build, shape, bounded = INITS[case]
    want = np.asarray(build(RI)(shape))
    got = build(TI)(shape, device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    sw = max(float(want.std()), 1e-6)
    assert abs(got.mean() - want.mean()) < MOMENT_TOL * sw
    assert abs(got.std() / sw - 1.0) < MOMENT_TOL
    if bounded:
        assert abs(got.min() - want.min()) < 0.05 * sw
        assert abs(got.max() - want.max()) < 0.05 * sw


def test_truncated_normal_stays_within_two_deviations():
    x = TI.TruncatedNormal(1.0, 0.5)([100000], device="cpu")
    assert float(x.min()) >= 0.0 and float(x.max()) <= 2.0


# -- the layer tail ---------------------------------------------------------------

def test_spectral_norm_is_the_reference_bit_for_bit_at_start():
    ref = rnn.SpectralNorm([6, 4, 3], dim=1, power_iters=2)
    port = tnn.SpectralNorm([6, 4, 3], dim=1, power_iters=2, device="cpu")
    for name in ("weight_u", "weight_v"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref,
                                                         name).numpy()))
    assert not port.weight_u.requires_grad
    w = np.random.RandomState(11).randn(6, 4, 3).astype(np.float32)
    for _ in range(2):  # the buffers move on each call
        wt = paddle.to_tensor(w, stop_gradient=False)
        want = ref(wt)
        tw = torch.from_numpy(w).requires_grad_(True)
        got = port(tw)
        np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(port.weight_u.numpy(),
                                   np.asarray(ref.weight_u.numpy()),
                                   rtol=RTOL, atol=ATOL)
        (wg,) = paddle.grad([want.sum()], [wt])
        (gg,) = torch.autograd.grad(got.sum(), [tw])
        np.testing.assert_allclose(gg.numpy(), _np(wg), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_generic_rnn_over_a_cell_matches_reference(with_lengths,
                                                    bidirectional):
    r = np.random.RandomState(12)
    x = _f(r, 3, 5, 4)
    lengths = np.array([5, 2, 4])
    outs = []
    for pkg, nn in ((paddle, rnn), (pt, tnn)):
        cells = [nn.GRUCell(4, 6, **_dev(nn)), nn.GRUCell(4, 6, **_dev(nn))]
        if pkg is pt:
            for cell, ref in zip(cells, ref_cells):
                load_reference_state(cell, {
                    n: np.asarray(t.numpy())
                    for n, t in ref.state_dict().items()})
        else:
            ref_cells = cells
        layer = (nn.BiRNN(cells[0], cells[1]) if bidirectional
                 else nn.RNN(cells[0]))
        kw = {"sequence_length": _tensor(pkg, lengths, False)[0]} \
            if with_lengths else {}
        xt = _tensor(pkg, x, True)[0]
        y, _ = layer(xt, **kw)
        (gx,) = pkg.grad([y.sum()], [xt])
        outs.append((_np(y), _np(gx)))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("form", ["functional", "layer"])
def test_maxout_at_a_negative_axis_is_the_reference_at_its_axis(form):
    """The port's ``axis=-1`` counts from the end (upstream Paddle's
    meaning); the reference reshapes across the leading axes there
    (ROADMAP queue 3, F12), so it is held to the reference's
    ``axis=x.ndim - 1``."""
    x = _f(np.random.RandomState(21), 2, 3, 3, 6)
    if form == "functional":
        want = RF.maxout(paddle.to_tensor(x), 2, axis=x.ndim - 1)
        got = F.maxout(torch.from_numpy(x), 2, axis=-1)
    else:
        want = rnn.Maxout(2, axis=x.ndim - 1)(paddle.to_tensor(x))
        got = tnn.Maxout(2, axis=-1)(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, 3, 3)
    np.testing.assert_array_equal(_np(got), _np(want))
