"""The transposed convolutions and the max-pool indices of the port against
the reference, on the CPU.

- ``conv1d/2d/3d_transpose``: the output, and the gradients of
  ``sum(out * c)`` with respect to the input, the weight and the bias,
  within 1e-5 of the reference's relative to the largest reference
  element (float32, XLA's fractionally strided convolution against
  torch's ``conv_transpose`` in another summation order), over stride,
  symmetric and uneven padding, ``output_padding`` at and beyond the
  stride, dilation, groups and both data formats.
- ``Conv1DTranspose``/``Conv2DTranspose`` from the reference's weights:
  the output within the same bound; the weight's shape and its
  initialization's bound are the reference's.
- ``max_pool2d_with_index`` on inputs after a ReLU (whole windows of
  zeros: ties) with padding and ``ceil_mode``: the mask equal (int32), the
  output and the input's gradient bitwise the reference's (a gather and
  its scatter-add of the same values). ``max_unpool2d`` with the default
  and a given ``output_size``: bitwise.
- ``MaxPool2D`` and ``AdaptiveMaxPool2D`` with ``return_mask=True``
  return the pooled output alone, as the reference's do.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.bridge import load_reference_state

REL = 1e-5

# (nd, stride, padding, output_padding, dilation, groups, data_format)
CASES = [
    (1, 2, 1, 1, 1, 1, "NCL"),
    (1, 3, [2, 0], 4, 1, 2, "NLC"),
    (2, 2, 1, 1, 1, 1, "NCHW"),
    (2, 1, 0, 0, 2, 1, "NCHW"),
    (2, 2, [1, 0, 2, 1], 0, 1, 2, "NCHW"),
    (2, 3, [0, 2, 1, 0], 2, 2, 2, "NHWC"),
    (2, 2, [2, 2], 3, 1, 1, "NHWC"),
    (3, 2, 1, 1, 1, 1, "NCDHW"),
    (3, 1, [1, 0, 0, 1, 1, 1], 0, 1, 2, "NDHWC"),
]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def _inputs(nd, groups, data_format, seed=0):
    rng = np.random.RandomState(seed)
    cin, cout = 4, 6
    spatial = (5, 6, 4)[:nd]
    shape = ((2, cin) + spatial if data_format[1] == "C"
             else (2,) + spatial + (cin,))
    return (rng.randn(*shape).astype("float32"),
            rng.randn(cin, cout // groups, *((3,) * nd)).astype("float32"),
            rng.randn(cout).astype("float32"))


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}d-s{c[1]}-p{c[2]}-op{c[3]}-d{c[4]}-g{c[5]}-{c[6]}"
    for c in CASES])
def test_conv_transpose_and_its_gradients_match_the_reference(case):
    nd, stride, padding, opad, dil, groups, fmt = case
    x, w, b = _inputs(nd, groups, fmt)
    name = f"conv{nd}d_transpose"
    ref_in = [paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b)]
    want = getattr(RF, name)(*ref_in, stride, padding, opad, dil, groups,
                             fmt)
    cot = np.random.RandomState(1).randn(*want.shape).astype("float32")
    (want * paddle.to_tensor(cot)).sum().backward()
    port_in = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    got = getattr(TF, name)(*port_in, stride, padding, opad, dil, groups,
                            fmt)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.detach().numpy(), want.numpy()) <= REL
    (got * torch.from_numpy(cot)).sum().backward()
    for p, r in zip(port_in, ref_in):
        assert _rel(p.grad.numpy(), r.grad.numpy()) <= REL


def test_string_padding_raises_as_in_the_reference():
    x, w, b = _inputs(2, 1, "NCHW")
    with pytest.raises(NotImplementedError, match="string padding"):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                            padding="SAME")


@pytest.mark.parametrize("nd", [1, 2])
def test_transposed_layers_from_the_reference_weights(nd):
    paddle.seed(5)
    cls = ("Conv1DTranspose", "Conv2DTranspose")[nd - 1]
    kw = dict(stride=2, padding=1, output_padding=1, groups=2)
    ref = getattr(paddle.nn, cls)(4, 6, 3, **kw)
    port = load_reference_state(getattr(tnn, cls)(4, 6, 3, device="cpu",
                                                  **kw),
                                {k: np.asarray(v.numpy())
                                 for k, v in ref.state_dict().items()})
    assert tuple(port.weight.shape) == tuple(ref.weight.shape) == (
        4, 3) + (3,) * nd
    x = _inputs(nd, 2, ("NCL", "NCHW")[nd - 1])[0]
    assert _rel(port(torch.from_numpy(x)).detach().numpy(),
                ref(paddle.to_tensor(x)).numpy()) <= REL
    # KaimingUniform(fan_in = in/groups * k^nd): the reference's bound
    fresh = getattr(tnn, cls)(4, 6, 3, device="cpu", **kw)
    bound = float(np.sqrt(6.0 / (2 * 3 ** nd)))
    assert float(fresh.weight.detach().abs().max()) <= bound
    assert float(np.abs(ref.weight.numpy()).max()) <= bound


POOLS = [(2, 2, 0, False), (3, 2, 1, True), (3, 2, [1, 0, 0, 1], True),
         (2, 1, 0, False), (3, 3, 1, False)]


def _relu_input(seed=0):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(2, 3, 7, 9).astype("float32"), 0.0)
    x[:, :, :3, :4] = 0.0  # whole windows of zeros: ties
    return x


@pytest.mark.parametrize("pool", POOLS, ids=[
    f"k{p[0]}-s{p[1]}-p{p[2]}-{'ceil' if p[3] else 'floor'}" for p in POOLS])
def test_max_pool2d_with_index_matches_the_reference(pool):
    k, s, p, ceil = pool
    x = _relu_input()
    rx = paddle.to_tensor(x, stop_gradient=False)
    want, want_mask = RF.max_pool2d_with_index(rx, k, s, p, ceil_mode=ceil)
    tx = torch.tensor(x, requires_grad=True)
    got, mask = TF.max_pool2d(tx, k, s, p, ceil_mode=ceil, return_mask=True)
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), want_mask.numpy())
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    cot = np.random.RandomState(2).randn(*want.shape).astype("float32")
    (want * paddle.to_tensor(cot)).sum().backward()
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), rx.grad.numpy())


@pytest.mark.parametrize("output_size", [None, (7, 9)])
@pytest.mark.parametrize("pool", POOLS[:3], ids=["k2s2", "k3s2p1",
                                                 "k3s2-uneven"])
def test_max_unpool2d_matches_the_reference(pool, output_size):
    k, s, p, ceil = pool
    x = _relu_input(3)
    pad = 0 if isinstance(p, list) else p
    rv, rm = RF.max_pool2d_with_index(paddle.to_tensor(x), k, s, p,
                                      ceil_mode=ceil)
    want = RF.max_unpool2d(rv, rm, k, s, pad, output_size=output_size)
    tv, tm = TF.max_pool2d_with_index(torch.from_numpy(x), k, s, p,
                                      ceil_mode=ceil)
    got = TF.max_unpool2d(tv, tm, k, s, pad, output_size=output_size)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_pooling_layers_take_return_mask_and_return_the_output():
    """The reference's ``MaxPool2D`` and ``AdaptiveMaxPool2D`` accept
    ``return_mask=True`` and return the pooled output alone; the port
    raised for ``AdaptiveMaxPool2D``."""
    x = _relu_input()
    for ref_layer, port_layer in (
            (paddle.nn.AdaptiveMaxPool2D(1, return_mask=True),
             tnn.AdaptiveMaxPool2D(1, return_mask=True)),
            (paddle.nn.MaxPool2D(2, 2, return_mask=True),
             tnn.MaxPool2D(2, 2, return_mask=True))):
        want = ref_layer(paddle.to_tensor(x))
        got = port_layer(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
