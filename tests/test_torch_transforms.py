"""``vision.transforms`` of the port against the reference's, on HWC
``uint8`` images and CHW ``float32`` arrays.

Every transform and functional gives the reference's array: exactly for
the crops, flips, ``ToTensor``, ``Normalize`` and ``Transpose`` (the same
numpy ops; the random ones draw the same numbers from one
``np.random.seed``). ``Resize`` against the reference's
``jax.image.resize(method="linear")``, up and down to several sizes:
float32 within 1e-5 (the same antialiased triangle weights; the axes
contracted in another order), ``uint8`` within 1 level (the cast truncates
a float that sits on an integer on one side and just below it on the
other), with the shape and dtype equal.
"""
import numpy as np
import pytest

from paddle_tpu.vision import transforms as R
from paddle_tpu_torch.vision import transforms as T

FLOAT_TOL = 1e-5


def _hwc(seed=0, shape=(40, 48, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _chw(seed=1, shape=(3, 24, 36)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


TRANSFORMS = {
    "ToTensor": lambda M: M.ToTensor(),
    "ToTensor-HWC": lambda M: M.ToTensor(data_format="HWC"),
    "Normalize-HWC": lambda M: M.Normalize([0.4, 0.5, 0.6], [0.2, 0.2, 0.3],
                                           data_format="HWC"),
    "CenterCrop": lambda M: M.CenterCrop(20),
    "CenterCrop-rect": lambda M: M.CenterCrop((16, 30)),
    "RandomCrop": lambda M: M.RandomCrop(24),
    "RandomCrop-padded": lambda M: M.RandomCrop((30, 30), padding=4),
    "RandomHorizontalFlip": lambda M: M.RandomHorizontalFlip(),
    "RandomVerticalFlip": lambda M: M.RandomVerticalFlip(0.7),
    "Transpose": lambda M: M.Transpose(),
    "Compose": lambda M: M.Compose([
        M.RandomCrop(32), M.RandomHorizontalFlip(), M.RandomVerticalFlip(),
        M.ToTensor(), M.Normalize([0.5] * 3, [0.25] * 3)]),
}
INPUTS = {"hwc-uint8": _hwc, "hwc-float": lambda: _hwc().astype(np.float32)}


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_reference(name, kind):
    img = INPUTS[kind]()
    ref, port = TRANSFORMS[name](R), TRANSFORMS[name](T)
    for draw in range(4):  # the random ones, over several draws
        np.random.seed(draw)
        want = ref(img)
        np.random.seed(draw)
        _same(port(img), want)


CHW_TRANSFORMS = {
    "Normalize": lambda M: M.Normalize([0.4, 0.5, 0.6], [0.2, 0.25, 0.3]),
    "CenterCrop": TRANSFORMS["CenterCrop"],
    "Transpose": lambda M: M.Transpose((1, 2, 0)),
}


@pytest.mark.parametrize("name", sorted(CHW_TRANSFORMS))
def test_transform_of_a_chw_float_array(name):
    img = _chw()
    _same(CHW_TRANSFORMS[name](T)(img), CHW_TRANSFORMS[name](R)(img))


RESIZES = [
    ((40, 48, 3), (20, 24)),     # down by 2
    ((40, 48, 3), (17, 31)),     # down, uneven
    ((40, 48, 3), (96, 100)),    # up
    ((300, 280, 3), (256, 256)),  # a decoded image to Resize(256)
    ((3, 24, 36), (12, 50)),     # CHW: the reference's rule
    ((33, 35), (16, 70)),        # HW
    ((1, 20, 30), (40, 40)),     # CHW, one channel
]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape, size", RESIZES,
                         ids=[f"{s}->{z}" for s, z in RESIZES])
def test_resize_matches_jax_image_resize(shape, size, dtype):
    rng = np.random.RandomState(7)
    img = (rng.randint(0, 256, shape).astype(np.uint8) if dtype == "uint8"
           else rng.rand(*shape).astype(np.float32))
    want = R.Resize(size)(img)
    got = T.Resize(size)(img)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert diff <= (1 if dtype == "uint8" else FLOAT_TOL), diff


def test_resize_of_an_int_size_is_square():
    img = _hwc()
    assert T.Resize(16)(img).shape == R.Resize(16)(img).shape == (16, 16, 3)


def test_functionals_match_the_reference():
    img = _hwc(3)
    _same(T.to_tensor(img), R.to_tensor(img))
    _same(T.to_tensor(img, "HWC"), R.to_tensor(img, "HWC"))
    chw = T.to_tensor(img)
    _same(T.normalize(chw, [0.1, 0.2, 0.3], [0.5, 0.6, 0.7]),
          R.normalize(chw, [0.1, 0.2, 0.3], [0.5, 0.6, 0.7]))
    got, want = T.resize(img, (20, 30)), R.resize(img, (20, 30))
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_transforms_stay_numpy_on_the_host():
    out = T.Compose([T.RandomCrop(24), T.ToTensor(),
                     T.Normalize(0.5, 0.5)])(_hwc())
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    assert out.shape == (3, 24, 24)
