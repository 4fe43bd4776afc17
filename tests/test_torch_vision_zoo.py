"""VGG and MobileNet of the port against the reference's, on the CPU, from
the reference's weights, and the datasets' synthetic arrays.

- VGG-11's features (``make_layers``, with and without BatchNorm) and
  MobileNetV1/V2 at ``scale=0.25`` (10 classes, dropout at rate 0 on both
  sides), batch 8 at 32 px, one ``Momentum`` step (the reference's as one
  ``to_static`` program): the loss within 5e-5 relative (measured 1.05e-5
  for MobileNetV2, whose last BatchNorms see 8 values a channel); the
  update of the parameters within 1e-2 of the reference's update
  (relative L2 over all of them) and the BatchNorm running statistics
  within 1e-5 + 1e-4 of their size. Float32 in another summation order; the update's
  bound is this loose because one ReLU input of 65,536 that rounds to the
  other side of zero (VGG-11's conv 6, against a float64 run of the port)
  moves the first layers' gradients by 1%: the update differs by 2.4e-3
  there and by 2.1e-4 for MobileNetV1, whose BatchNorm weight gradients
  are sums that cancel.
- The whole VGG-11 (its 7 x 7 pool and classifier need 224 px) in eval
  mode on one image: the logits within 1e-4 of the largest.
- ``Cifar10``, ``Cifar100`` and ``FashionMNIST`` build the reference's
  seeded arrays exactly; ``pretrained=True`` raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.vision import models as RM
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.vision import models as TM

LOSS_REL, UPDATE_REL, LOGIT_TOL = 5e-5, 1e-2, 1e-4
BUFFER_REL, BUFFER_TOL = 1e-4, 1e-5
LR = 0.05
BATCH = 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _no_dropout(net, cls):
    layers = net.sublayers() if cls is paddle.nn.Dropout else net.modules()
    for m in layers:
        if isinstance(m, cls):
            m.p = 0.0
    return net


def _vgg_features(M, bn, **kw):
    return M.VGG(M.vgg.make_layers(M.vgg.cfgs["A"], bn, **kw),
                 num_classes=0, with_pool=False, **kw)


BUILDS = {
    "vgg11-features": (lambda M, **kw: _vgg_features(M, False, **kw), 32),
    "vgg11-features-bn": (lambda M, **kw: _vgg_features(M, True, **kw), 32),
    "mobilenet_v1-0.25": (lambda M, **kw: M.mobilenet_v1(
        scale=0.25, num_classes=10, **kw), 32),
    "mobilenet_v2-0.25": (lambda M, **kw: M.mobilenet_v2(
        scale=0.25, num_classes=10, **kw), 32),
}


def _logits(out):
    """Features only: the mean over the map stands in for the logits."""
    return out.mean(axis=[2, 3]) if out.ndim == 4 else out


def _ref_step(net, x, y):
    """One Momentum step of the reference as one program (``to_static``:
    one XLA compile instead of one a primitive)."""
    opt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                    parameters=net.parameters())

    def one(xb, yb):
        loss = paddle.nn.functional.cross_entropy(_logits(net(xb)), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return float(paddle.jit.to_static(one)(
        paddle.to_tensor(x), paddle.to_tensor(y)).numpy())


def _port_step(net, x, y):
    opt = pt.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                parameters=net.parameters())
    out = net(torch.from_numpy(x))
    loss = pt.nn.functional.cross_entropy(
        out.mean(dim=(2, 3)) if out.dim() == 4 else out, torch.from_numpy(y))
    loss.backward()
    opt.step()
    return float(loss.detach())


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_one_training_step_matches_the_reference(name):
    build, size = BUILDS[name]
    paddle.seed(7)
    ref = _no_dropout(build(RM), paddle.nn.Dropout)
    start = _state(ref)
    port = load_reference_state(build(TM, device="cpu"), start)
    port = _no_dropout(port, pt.nn.Dropout)
    rng = np.random.RandomState(8)
    x = rng.rand(BATCH, 3, size, size).astype("float32")
    y = rng.randint(0, 10, BATCH).astype("int64")
    ref.train()
    port.train()
    want = _ref_step(ref, x, y)
    got = _port_step(port, x, y)
    assert abs(got - want) <= LOSS_REL * abs(want)
    ref_state, port_state = _state(ref), port.state_dict()
    params = [k for k in ref_state if not k.endswith(("_mean", "_variance"))]
    a = np.concatenate([port_state[k].detach().numpy().ravel()
                        for k in params])
    b = np.concatenate([ref_state[k].ravel() for k in params])
    a0 = np.concatenate([start[k].ravel() for k in params])
    assert np.linalg.norm(a - b) <= UPDATE_REL * np.linalg.norm(b - a0)
    for k in ref_state:
        if k.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(port_state[k].numpy(), ref_state[k],
                                       rtol=BUFFER_REL, atol=BUFFER_TOL)


def test_whole_vgg11_forward_matches_the_reference():
    paddle.seed(9)
    ref = RM.vgg11(num_classes=10)
    port = load_reference_state(TM.vgg11(num_classes=10, device="cpu"),
                                _state(ref))
    ref.eval()
    port.eval()
    x = np.random.RandomState(10).rand(1, 3, 224, 224).astype("float32")
    want = ref(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 10)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("build", ["vgg16", "mobilenet_v1",
                                   "mobilenet_v2"])
def test_pretrained_raises(build):
    with pytest.raises(ValueError, match="nothing is downloaded"):
        getattr(TM, build)(pretrained=True)


def test_the_zoo_exports_the_references_names():
    for name in ("VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1",
                 "MobileNetV2", "mobilenet_v1", "mobilenet_v2"):
        assert hasattr(TM, name) and hasattr(RM, name)
    layers = [type(m).__name__ for m in TM.vgg19(batch_norm=True,
                                                 num_classes=0,
                                                 device="cpu").features]
    assert layers.count("Conv2D") == 16 and layers.count("BatchNorm2D") == 16


@pytest.mark.parametrize("name", ["Cifar10", "Cifar100", "FashionMNIST",
                                  "MNIST"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_datasets_build_the_references_arrays(name, mode):
    got = getattr(pt.vision.datasets, name)(mode=mode)
    want = getattr(paddle.vision.datasets, name)(mode=mode)
    assert isinstance(got, pt.io.Dataset) and got.synthetic
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in (0, len(got) - 1):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
