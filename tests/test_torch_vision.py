"""The convolutional path on the CPU: each functional and layer of the
port's vision slice against the reference's, on the same numpy inputs made
from a seed and the same weights (moved by ``bridge``): convolutions in
both layouts with groups, strides, dilations and every padding form;
BatchNorm in training (with its running buffers after 3 steps), in eval and
with ``use_global_stats``, and under bf16 ``auto_cast``; max, average and
adaptive pooling with ``exclusive``, ``ceil_mode`` and a non-divisible
adaptive case; LeNet; ResNet-18 and ResNet-50 at 32 x 32 with 10 classes,
forward and every gradient (ResNet-50's eval forward too).

Tolerances:

- functionals, layers, LeNet and ResNet-18 in float32: outputs and
  gradients within 1e-5 absolute and relative (the same float32 math in
  another order; convolution gradients 1e-4 relative to their largest
  element, sums over up to 2 x 9 x 9 products), BatchNorm's buffers within
  1e-5; ResNet-18's logits 1e-4 relative L2, its gradients 1e-3 relative L2
  over all of them together and 1e-3 of the largest gradient element
  (measured 1.4e-5, 7.2e-5 and 8.1e-5);
- ResNet-50 in training mode: at 32 x 32 its last stages normalise 2 x 2
  and 1 x 1 maps over a batch of 4, which amplifies float32 rounding: the
  port in float32 against itself in float64 already differs by 3-5% on the
  worst BatchNorm bias gradient. So the reference is held to the port
  within 4 x the port's own float32 distance from float64 (the loss, the
  logits and all gradients together, each by relative L2); in eval mode
  (BatchNorm an affine map, after the training step's buffer update) its
  logits within 1e-4 relative L2;
- bf16 under ``auto_cast``: a convolution's and a BatchNorm's outputs and
  ResNet-18's loss (64 x 64, batch 1) within 2e-2 relative, its logits 5e-2
  relative L2 (bf16 rounds in other places on the two sides, and each
  BatchNorm over a small map amplifies it: measured 2.2e-2 after the last
  stage); BatchNorm's float32 buffers within 1e-3 relative (the batch
  statistics rounded to bf16 first, as the reference rounds them).
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as pnn
import paddle_tpu.nn.functional as PF
from paddle_tpu.vision import datasets as ref_datasets
from paddle_tpu.vision import models as ref_models
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp, ops
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.vision import datasets, models

TOL = 1e-5
CONV_GRAD_REL = 1e-4
BUFFER_TOL = 1e-5
RES18_LOGIT_REL, RES18_GRAD_REL = 1e-4, 1e-3
RES50_EVAL_LOGIT_REL = 1e-4
RES50_TRAIN_FACTOR = 4.0
BF16_REL = 2e-2
BF16_LOGIT_REL = 5e-2
BF16_BUFFER_REL = 1e-3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _state(layer):
    return {n: np.asarray(t.numpy()) for n, t in layer.state_dict().items()}


def _ref_grads(fn, arrays, cot):
    """The reference's output of ``fn`` and the gradients of ``sum(out *
    cot)`` for every input."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * paddle.to_tensor(cot)).sum().backward()
    return out.numpy(), [np.asarray(t.grad.numpy()) for t in ts]


def _port_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(name, got, want, tol=TOL):
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


# -- convolutions ------------------------------------------------------------

CONVS = {  # name: (nd, data_format, x shape, weight shape, keywords)
    "2d_nchw": (2, "NCHW", (2, 4, 9, 9), (6, 4, 3, 3), dict(padding=1)),
    "2d_nhwc_stride2_groups2": (2, "NHWC", (2, 9, 9, 4), (6, 2, 3, 3),
                                dict(stride=2, padding=[1, 0], groups=2)),
    "2d_dilation2_same_stride2": (2, "NCHW", (2, 3, 10, 11), (4, 3, 3, 3),
                                  dict(stride=2, dilation=2,
                                       padding="SAME")),
    "2d_valid_stride_pair": (2, "NCHW", (2, 3, 9, 8), (5, 3, 3, 2),
                             dict(stride=[2, 1], padding="VALID")),
    "2d_uneven_pads": (2, "NHWC", (2, 7, 8, 3), (4, 3, 3, 3),
                       dict(padding=[0, 2, 1, 0])),
    "2d_depthwise": (2, "NCHW", (2, 4, 8, 8), (8, 1, 3, 3),
                     dict(padding=1, groups=4)),
    "2d_7x7_stride2_pad3": (2, "NCHW", (2, 3, 16, 16), (8, 3, 7, 7),
                            dict(stride=2, padding=3)),
    "1d_ncl": (1, "NCL", (2, 4, 11), (6, 4, 3), dict(padding=1)),
    "1d_nlc_stride2_groups2": (1, "NLC", (2, 11, 4), (6, 2, 3),
                               dict(stride=2, groups=2, dilation=2)),
    "3d_ncdhw": (3, "NCDHW", (2, 3, 5, 6, 6), (4, 3, 3, 3, 3),
                 dict(padding=1, stride=[1, 2, 2])),
    "3d_ndhwc_dilation": (3, "NDHWC", (2, 5, 6, 6, 3), (4, 3, 2, 2, 2),
                          dict(dilation=2, padding="SAME")),
}


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_reference(name, bias):
    nd, fmt, xs, ws, kw = CONVS[name]
    rng = np.random.RandomState(sorted(CONVS).index(name))
    arrays = [rng.randn(*xs).astype("float32"),
              rng.randn(*ws).astype("float32")]
    if bias:
        arrays.append(rng.randn(ws[0]).astype("float32"))
    fn_name = f"conv{nd}d"

    def run(F):
        return lambda x, w, *b: getattr(F, fn_name)(
            x, w, b[0] if b else None, data_format=fmt, **kw)

    want, want_g = _ref_grads(run(PF), arrays, np.ones(1, "float32"))
    cot = rng.randn(*want.shape).astype("float32")
    want, want_g = _ref_grads(run(PF), arrays, cot)
    got, got_g = _port_grads(run(TF), arrays, cot)
    _check(name, got, want)
    for i, (g, r) in enumerate(zip(got_g, want_g)):
        assert np.abs(g - r).max() <= CONV_GRAD_REL * np.abs(r).max(), \
            (name, i)


def test_conv_under_auto_cast_is_bf16_and_keeps_the_input_dtype():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 8, 8).astype("float32")
    w = rng.randn(6, 4, 3, 3).astype("float32") * 0.2
    with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
        want = PF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), padding=1)
    with amp.auto_cast(enable=True, dtype="bfloat16"):
        got = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert got.dtype == torch.bfloat16 and "bfloat16" in str(want.dtype)
    want32 = np.asarray(want.numpy()).astype("float32")
    assert _rel(got.float().numpy(), want32) <= BF16_REL


# -- BatchNorm ----------------------------------------------------------------

BNS = {  # name: (layer, x shape, keywords)
    "2d_nchw": ("BatchNorm2D", (4, 3, 5, 5), {}),
    "2d_nhwc": ("BatchNorm2D", (4, 5, 5, 3), dict(data_format="NHWC")),
    "2d_momentum_0.5": ("BatchNorm2D", (4, 3, 5, 5), dict(momentum=0.5)),
    "1d_ncl": ("BatchNorm1D", (4, 3, 7), {}),
    "1d_nc": ("BatchNorm1D", (8, 3), {}),
    "3d": ("BatchNorm3D", (2, 3, 3, 4, 4), {}),
    "fluid_batchnorm": ("BatchNorm", (4, 3, 5, 5), {}),
    "use_global_stats": ("BatchNorm2D", (4, 3, 5, 5),
                         dict(use_global_stats=True)),
}


def _bn_pair(name, rng):
    cls, xs, kw = BNS[name]
    channels = xs[-1] if kw.get("data_format") == "NHWC" else xs[1]
    ref = getattr(pnn, cls)(channels, **kw)
    ref.set_state_dict({n: (rng.rand(*v.shape) + 0.5 if "var" in n
                            else rng.randn(*v.shape)).astype("float32")
                        for n, v in _state(ref).items()})
    port = load_reference_state(getattr(tnn, cls)(channels, **kw,
                                                  device="cpu"), _state(ref))
    return ref, port, xs


@pytest.mark.parametrize("name", sorted(BNS))
def test_batch_norm_matches_reference_over_three_steps(name):
    rng = np.random.RandomState(sorted(BNS).index(name))
    ref, port, xs = _bn_pair(name, rng)
    for step in range(3):
        x = (rng.randn(*xs) * 2 + 1).astype("float32")
        cot = rng.randn(*xs).astype("float32")
        want, want_g = _ref_grads(ref, [x], cot)
        got, got_g = _port_grads(port, [x], cot)
        _check(f"{name} step {step} out", got, want)
        _check(f"{name} step {step} dx", got_g[0], want_g[0], 1e-4)
        for n, p in port.named_parameters():
            r = dict(ref.named_parameters())[n]
            _check(f"{name} step {step} d{n}", p.grad.numpy(),
                   np.asarray(r.grad.numpy()), 1e-4)
            p.grad = None
        ref.clear_gradients()
    want_state = _state(ref)
    for n, t in port.state_dict().items():
        _check(f"{name} {n} after 3 steps", t.numpy(), want_state[n],
               BUFFER_TOL)
    ref.eval()
    port.eval()
    x = rng.randn(*xs).astype("float32")
    want = ref(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _check(f"{name} eval", got, want)


def test_batch_norm_under_auto_cast_matches_reference():
    """A bf16 input (a convolution's output under AMP): computed in
    float32, returned in bf16, the buffers updated from bf16 statistics."""
    rng = np.random.RandomState(7)
    ref, port, xs = _bn_pair("2d_nchw", rng)
    x = (rng.randn(*xs) * 2 + 1).astype("float32")
    with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
        want = ref(paddle.to_tensor(x).astype("bfloat16"))
    with amp.auto_cast(enable=True, dtype="bfloat16"):
        got = port(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and "bfloat16" in str(want.dtype)
    assert _rel(got.detach().float().numpy(),
                np.asarray(want.numpy()).astype("float32")) <= BF16_REL
    want_state = _state(ref)
    for n, t in port.state_dict().items():
        assert t.dtype == torch.float32
        assert _rel(t.numpy(), want_state[n]) <= BF16_BUFFER_REL, n


def test_batch_norm_promotes_a_bf16_input_without_auto_cast():
    """A bf16 input meets float32 parameters outside ``auto_cast``: the
    result is float32 in training and eval, as the reference's promotion
    makes it (the reference normalises in bf16 before the float32 scale,
    the port in float32: within bf16 rounding)."""
    rng = np.random.RandomState(8)
    ref, port, xs = _bn_pair("2d_nchw", rng)
    x = (rng.randn(*xs) * 2 + 1).astype("float32")
    for mode in ("train", "eval"):
        getattr(ref, mode)()
        getattr(port, mode)()
        want = ref(paddle.to_tensor(x).astype("bfloat16"))
        got = port(torch.from_numpy(x).bfloat16())
        assert got.dtype == torch.float32 and "float32" in str(want.dtype)
        assert _rel(got.detach().numpy(), np.asarray(want.numpy())) \
            <= BF16_REL, mode


# -- pooling ------------------------------------------------------------------

POOLS = {  # name: (functional, x shape, keywords)
    "max2d_k3s2p1": ("max_pool2d", (2, 3, 9, 9), dict(kernel_size=3,
                                                      stride=2, padding=1)),
    "max2d_k2s2": ("max_pool2d", (2, 3, 8, 8), dict(kernel_size=2, stride=2)),
    "max2d_ceil_8": ("max_pool2d", (2, 3, 8, 8),
                     dict(kernel_size=3, stride=2, ceil_mode=True)),
    "max2d_ceil_p1_7": ("max_pool2d", (2, 3, 7, 7),
                        dict(kernel_size=3, stride=2, padding=1,
                             ceil_mode=True)),
    "max2d_ceil_window_in_pad": ("max_pool2d", (2, 3, 6, 6),
                                 dict(kernel_size=2, stride=2, padding=1,
                                      ceil_mode=True)),
    "max2d_nhwc_same": ("max_pool2d", (2, 8, 7, 3),
                        dict(kernel_size=3, stride=2, padding="SAME",
                             data_format="NHWC")),
    "max1d_ceil": ("max_pool1d", (2, 3, 10), dict(kernel_size=3, stride=2,
                                                  ceil_mode=True)),
    "max3d": ("max_pool3d", (2, 2, 5, 6, 6), dict(kernel_size=2, stride=2,
                                                  padding=[0, 1, 1])),
    "avg2d_exclusive_p1": ("avg_pool2d", (2, 3, 9, 9),
                           dict(kernel_size=3, stride=2, padding=1)),
    "avg2d_inclusive_p1": ("avg_pool2d", (2, 3, 9, 9),
                           dict(kernel_size=3, stride=2, padding=1,
                                exclusive=False)),
    "avg2d_ceil_exclusive": ("avg_pool2d", (2, 3, 8, 8),
                             dict(kernel_size=3, stride=2, ceil_mode=True)),
    "avg2d_ceil_inclusive": ("avg_pool2d", (2, 3, 8, 8),
                             dict(kernel_size=3, stride=2, ceil_mode=True,
                                  exclusive=False)),
    "avg2d_ceil_window_in_pad": ("avg_pool2d", (2, 3, 6, 6),
                                 dict(kernel_size=2, stride=2, padding=1,
                                      ceil_mode=True)),
    "avg2d_uneven_pads_nhwc": ("avg_pool2d", (2, 7, 8, 3),
                               dict(kernel_size=3, stride=1,
                                    padding=[0, 1, 1, 0],
                                    data_format="NHWC")),
    "avg1d_ceil": ("avg_pool1d", (2, 3, 10), dict(kernel_size=3, stride=2,
                                                  ceil_mode=True)),
    "avg3d": ("avg_pool3d", (2, 2, 5, 6, 6), dict(kernel_size=2, stride=2,
                                                  padding=1)),
    "adaptive_avg_7_to_1": ("adaptive_avg_pool2d", (2, 3, 7, 7),
                            dict(output_size=1)),
    "adaptive_avg_8_to_2x4": ("adaptive_avg_pool2d", (2, 3, 8, 8),
                              dict(output_size=[2, 4])),
    "adaptive_avg_7_to_3_nondivisible": ("adaptive_avg_pool2d",
                                         (2, 3, 7, 10),
                                         dict(output_size=[3, 4])),
    "adaptive_avg_nondivisible_nhwc": ("adaptive_avg_pool2d", (2, 7, 10, 3),
                                       dict(output_size=[3, 4],
                                            data_format="NHWC")),
    "adaptive_max_8_to_2": ("adaptive_max_pool2d", (2, 3, 8, 8),
                            dict(output_size=2)),
    "adaptive_avg1d": ("adaptive_avg_pool1d", (2, 3, 12),
                       dict(output_size=4)),
}


@pytest.mark.parametrize("name", sorted(POOLS))
def test_pooling_matches_reference(name):
    fn, xs, kw = POOLS[name]
    rng = np.random.RandomState(sorted(POOLS).index(name))
    x = rng.randn(*xs).astype("float32")
    want, _ = _ref_grads(lambda t: getattr(PF, fn)(t, **kw), [x],
                         np.ones(1, "float32"))
    cot = rng.randn(*want.shape).astype("float32")
    want, (want_g,) = _ref_grads(lambda t: getattr(PF, fn)(t, **kw), [x],
                                 cot)
    got, (got_g,) = _port_grads(lambda t: getattr(TF, fn)(t, **kw), [x], cot)
    _check(name, got, want)
    _check(name + " grad", got_g, want_g)


def test_nondivisible_adaptive_bins_are_the_references_not_torchs():
    """The reference's bins (``np.linspace``) do not overlap; torch's
    (floor/ceil windows) do: the port computes the reference's."""
    x = torch.arange(7.0).reshape(1, 1, 1, 7)
    got = TF.adaptive_avg_pool2d(x, [1, 3])
    assert got.flatten().tolist() == [0.5, 2.5, 5.0]  # bins 0:2, 2:4, 4:7
    torchs = torch.nn.functional.adaptive_avg_pool2d(x, (1, 3))
    assert torchs.flatten().tolist() == [1.0, 3.0, 5.0]  # 0:3, 2:5, 4:7


def test_pooling_layers_match_their_functionals():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 8, 8).astype("float32"))
    for layer, fn, kw in (
            (tnn.MaxPool2D(3, 2, 1, ceil_mode=True), TF.max_pool2d,
             dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)),
            (tnn.AvgPool2D(3, 2, 1, exclusive=False), TF.avg_pool2d,
             dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
            (tnn.AdaptiveAvgPool2D((1, 1)), TF.adaptive_avg_pool2d,
             dict(output_size=(1, 1))),
            (tnn.AdaptiveMaxPool2D(2), TF.adaptive_max_pool2d,
             dict(output_size=2))):
        assert torch.equal(layer(x), fn(x, **kw))


# -- containers, ops, datasets ------------------------------------------------

def test_sequential_names_sublayers_as_the_reference():
    ref = pnn.Sequential(pnn.Linear(2, 3), pnn.ReLU(), pnn.Linear(3, 1))
    port = tnn.Sequential(tnn.Linear(2, 3, device="cpu"), tnn.ReLU(),
                          tnn.Linear(3, 1, device="cpu"))
    assert list(port.state_dict()) == list(ref.state_dict())
    assert len(port) == 3 and isinstance(port[1], tnn.ReLU)
    assert len(port[1:]) == 2
    named = tnn.Sequential(("a", tnn.ReLU()), ("b", tnn.ReLU()))
    assert [n for n, _ in named.named_children()] == ["a", "b"]


def test_flatten_matches_reference():
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype("float32")
    for start, stop in ((1, -1), (0, 2), (2, 3)):
        want = paddle.flatten(paddle.to_tensor(x), start, stop).numpy()
        got = ops.flatten(torch.from_numpy(x), start, stop).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_mnist_synthetic_set_is_the_references(mode):
    ref = ref_datasets.MNIST(mode=mode)
    port = datasets.MNIST(mode=mode)
    assert port.synthetic and len(port) == len(ref) == 4096
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    for i in (0, 17, 4095):
        for a, b in zip(port[i], ref[i]):
            np.testing.assert_array_equal(a, b)


# -- models -------------------------------------------------------------------

def test_models_run_on_the_card_unless_asked_and_take_no_pretrained():
    with pytest.raises(ValueError, match="nothing is downloaded"):
        models.resnet18(pretrained=True, device="cpu")
    m = models.resnet18(num_classes=10, device="cpu")
    assert {p.device.type for p in m.state_dict().values()} == {"cpu"}
    if not torch.cuda.is_available():
        for build in (lambda: models.resnet18(num_classes=10),
                      lambda: models.LeNet(),
                      lambda: tnn.BatchNorm2D(4),
                      lambda: tnn.Conv2D(3, 4, 3)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


_REFERENCES = {}


def _reference(name):
    """The reference model ``name`` (10 classes), built once a process (its
    eager first calls compile every op) and reset to its initial state, in
    training mode, on every call."""
    if name not in _REFERENCES:
        paddle.seed(0)
        ref = getattr(ref_models, name)(num_classes=10)
        _REFERENCES[name] = (ref, _state(ref))
    ref, initial = _REFERENCES[name]
    ref.set_state_dict(initial)
    ref.clear_gradients()
    ref.train()
    return ref


@pytest.mark.parametrize("name", ["LeNet", "resnet18", "resnet50"])
def test_state_dict_names_and_shapes_are_the_references(name):
    ref = _reference(name)
    port = getattr(models, name)(num_classes=10, device="cpu")
    want = {n: tuple(v.shape) for n, v in _state(ref).items()}
    assert {n: tuple(t.shape) for n, t in port.state_dict().items()} == want
    assert ([n for n, _ in port.named_parameters()]
            == [n for n, _ in ref.named_parameters()])


def _model_pair(name):
    ref = _reference(name)
    port = load_reference_state(
        getattr(models, name)(num_classes=10, device="cpu"), _state(ref))
    return ref, port


def _ref_loss_and_grads(ref, x, y):
    logits = ref(paddle.to_tensor(x))
    loss = PF.cross_entropy(logits, paddle.to_tensor(y))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()}
    ref.clear_gradients()
    return float(loss.numpy()), np.asarray(logits.numpy()), grads


def _port_loss_and_grads(port, x, y):
    logits = port(torch.from_numpy(x))
    loss = TF.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}
    port.clear_gradients()
    return loss.item(), logits.detach().numpy(), grads


def _flat(grads, names):
    return np.concatenate([grads[n].ravel().astype("float64")
                           for n in names])


def _images(shape, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype("float32"),
            rng.randint(0, 10, (shape[0],)).astype("int64"))


def test_lenet_matches_reference():
    ref, port = _model_pair("LeNet")
    data = datasets.MNIST(mode="train")
    x = np.stack([data[i][0] for i in range(8)])
    y = np.stack([data[i][1] for i in range(8)])
    want_loss, want_logits, want_g = _ref_loss_and_grads(ref, x, y)
    loss, logits, grads = _port_loss_and_grads(port, x, y)
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    _check("lenet logits", logits, want_logits)
    for n in want_g:
        assert _rel(grads[n], want_g[n]) <= 1e-4, n


def test_resnet18_matches_reference_in_training_mode():
    ref, port = _model_pair("resnet18")
    x, y = _images((4, 3, 32, 32))
    want_loss, want_logits, want_g = _ref_loss_and_grads(ref, x, y)
    loss, logits, grads = _port_loss_and_grads(port, x, y)
    names = list(want_g)
    assert abs(loss - want_loss) <= RES18_LOGIT_REL * abs(want_loss)
    assert _rel(logits, want_logits) <= RES18_LOGIT_REL
    g, w = _flat(grads, names), _flat(want_g, names)
    assert _rel(g, w) <= RES18_GRAD_REL
    assert np.abs(g - w).max() <= RES18_GRAD_REL * np.abs(w).max()
    want_state = _state(ref)  # the running statistics after one step
    for n, t in port.state_dict().items():
        if n.endswith(("_mean", "_variance")):
            _check(n, t.numpy(), want_state[n], 1e-4)


def test_resnet50_matches_reference():
    ref, port = _model_pair("resnet50")
    x, y = _images((4, 3, 32, 32))
    names = [n for n, _ in port.named_parameters()]
    # training mode: within 4 x the port's own float32 error
    exact = copy.deepcopy(port).double()
    logits64 = exact(torch.from_numpy(x).double())
    loss64 = TF.cross_entropy(logits64, torch.from_numpy(y))
    loss64.backward()
    g64 = {n: p.grad.numpy() for n, p in exact.named_parameters()}
    want_loss, want_logits, want_g = _ref_loss_and_grads(ref, x, y)
    loss, logits, grads = _port_loss_and_grads(port, x, y)
    own = (abs(loss - loss64.item()) / abs(loss64.item()),
           _rel(logits, logits64.detach().numpy()),
           _rel(_flat(grads, names), _flat(g64, names)))
    theirs = (abs(loss - want_loss) / abs(want_loss),
              _rel(logits, want_logits),
              _rel(_flat(grads, names), _flat(want_g, names)))
    for what, a, b in zip(("loss", "logits", "gradients"), theirs, own):
        assert a <= RES50_TRAIN_FACTOR * b, (what, a, b)
    # eval mode: BatchNorm an affine map of the running statistics
    ref.eval()
    port.eval()
    x, _ = _images((2, 3, 32, 32), seed=2)
    want_logits = ref(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        logits = port(torch.from_numpy(x)).numpy()
    assert _rel(logits, want_logits) <= RES50_EVAL_LOGIT_REL


def test_resnet_under_auto_cast_matches_reference():
    """At 64 x 64: at 32 x 32 the last stage normalises 1 x 1 maps over a
    small batch, where a bf16 rounding decides the result."""
    ref, port = _model_pair("resnet18")
    x, y = _images((1, 3, 64, 64), seed=3)
    with paddle.amp.auto_cast(enable=True, dtype="bfloat16"):
        want_logits = ref(paddle.to_tensor(x))
        want = float(PF.cross_entropy(want_logits, paddle.to_tensor(y))
                     .numpy())
    with amp.auto_cast(enable=True, dtype="bfloat16"):
        logits = port(torch.from_numpy(x))
        got = TF.cross_entropy(logits, torch.from_numpy(y)).item()
    assert logits.dtype == torch.bfloat16
    assert abs(got - want) <= BF16_REL * abs(want)
    assert _rel(logits.detach().float().numpy(), np.asarray(
        want_logits.numpy()).astype("float32")) <= BF16_LOGIT_REL
