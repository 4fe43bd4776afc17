"""``incubate``'s own ops against the reference: the fused masked
softmaxes (float32 and bf16), the four segment reductions (with the
gradients of sum and mean, empty segments, the length read from the last
sorted id), and ``load_custom_op`` on a library built with g++ under
``tmp_path``: forward and backward against the reference's op on the same
library, the missing backward and the missing symbol, and the refusal
inside a CUDA-graph capture (the capture simulated on the CPU).

Tolerances: float32 within 1e-6 absolute (softmax outputs lie in [0, 1])
and segment results and gradients within 1e-6 relative to their largest
element; bf16 softmax within 1e-2 absolute (torch's softmax rounds once
from float32, jnp's bf16 softmax at each step); the custom op exact (the
same C function on the same float32 inputs).
"""
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate as RI
import paddle_tpu_torch.incubate as TI

F32_TOL, BF16_TOL = 1e-6, 1e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else t.numpy(), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_mask_fuse_upper_triangle(dtype):
    x = np.random.RandomState(0).randn(2, 3, 6, 6).astype(np.float32) * 3
    ref = RI.softmax_mask_fuse_upper_triangle(
        paddle.to_tensor(x).astype(dtype))
    got = TI.softmax_mask_fuse_upper_triangle(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=tol)
    assert float(torch.triu(got.float(), 1).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_mask_fuse(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 5, 5).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 5, 5) < 0.3, -1e4, 0.0).astype(np.float32)
    ref = RI.softmax_mask_fuse(paddle.to_tensor(x).astype(dtype),
                               paddle.to_tensor(mask).astype(dtype))
    got = TI.softmax_mask_fuse(torch.from_numpy(x).to(getattr(torch, dtype)),
                               torch.from_numpy(mask).to(getattr(torch,
                                                                 dtype)))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=tol)


def test_softmax_mask_fuse_gradient():
    x = np.random.RandomState(2).randn(1, 2, 4, 4).astype(np.float32)
    w = np.random.RandomState(3).randn(1, 2, 4, 4).astype(np.float32)
    rx = paddle.to_tensor(x, stop_gradient=False)
    (RI.softmax_mask_fuse_upper_triangle(rx) * paddle.to_tensor(w)).sum() \
        .backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    (TI.softmax_mask_fuse_upper_triangle(tx) * torch.from_numpy(w)).sum() \
        .backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rx.grad.numpy()),
                               rtol=0, atol=F32_TOL)


SEG_IDS = np.array([0, 0, 1, 3, 3, 3, 5], np.int64)  # 2 and 4 empty


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
def test_segment_ops_match(kind):
    data = np.random.RandomState(4).randn(7, 3).astype(np.float32)
    ref = getattr(RI, f"segment_{kind}")(paddle.to_tensor(data),
                                         paddle.to_tensor(SEG_IDS))
    got = getattr(TI, f"segment_{kind}")(torch.from_numpy(data),
                                         torch.from_numpy(SEG_IDS))
    assert tuple(got.shape) == (6, 3) == tuple(ref.shape)
    want = _np(ref)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())
    assert np.all(_np(got)[[2, 4]] == 0)


@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_segment_gradients_match(kind):
    data = np.random.RandomState(5).randn(7, 2).astype(np.float32)
    w = np.random.RandomState(6).randn(6, 2).astype(np.float32)
    rd = paddle.to_tensor(data, stop_gradient=False)
    (getattr(RI, f"segment_{kind}")(rd, paddle.to_tensor(SEG_IDS))
     * paddle.to_tensor(w)).sum().backward()
    td = torch.from_numpy(data).requires_grad_(True)
    (getattr(TI, f"segment_{kind}")(td, torch.from_numpy(SEG_IDS))
     * torch.from_numpy(w)).sum().backward()
    want = np.asarray(rd.grad.numpy())
    np.testing.assert_allclose(td.grad.numpy(), want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())


def test_segment_empty_ids():
    out = TI.segment_sum(torch.zeros(0, 3), torch.zeros(0, dtype=torch.int64))
    assert tuple(out.shape) == (0, 3)


CUSTOM_OP_SRC = r"""
#include <cstdint>
extern "C" {
// y = x^2 + 1
void sq1_forward(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = x[i] * x[i] + 1.0f;
}
void sq1_backward(const float* x, const float* gy, float* gx, int64_t n) {
  for (int64_t i = 0; i < n; ++i) gx[i] = 2.0f * x[i] * gy[i];
}
// no backward exported for this one
void plain_forward(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = x[i] + 3.0f;
}
}
"""


@pytest.fixture(scope="module")
def so_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("customop")
    src = d / "my_op.cc"
    src.write_text(CUSTOM_OP_SRC)
    so = d / "my_op.so"
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", str(src), "-o",
                    str(so)], check=True)
    return str(so)


def test_custom_op_forward_and_backward_match(so_path):
    x = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    w = np.random.RandomState(8).randn(3, 4).astype(np.float32)
    rop = RI.load_custom_op(so_path, "sq1")
    top = TI.load_custom_op(so_path, "sq1")
    assert top.has_backward and top.__name__ == "custom_sq1"
    rx = paddle.to_tensor(x, stop_gradient=False)
    ry = rop(rx)
    (ry * paddle.to_tensor(w)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = top(tx)
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(ry.numpy()))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(rx.grad.numpy()))
    np.testing.assert_array_equal(ty.detach().numpy(), x * x + 1)
    assert ty.dtype == torch.float32 and ty.device == tx.device


def test_custom_op_missing_backward_and_symbol(so_path):
    from paddle_tpu_torch.core.enforce import NotFoundError
    op = TI.load_custom_op(so_path, "plain")
    assert not op.has_backward
    x = torch.tensor([1.0, -2.0], requires_grad=True)
    y = op(x)
    np.testing.assert_array_equal(y.detach().numpy(), [4.0, 1.0])
    with pytest.raises(NotImplementedError, match="plain_backward"):
        y.sum().backward()
    with pytest.raises(NotFoundError, match="nonexistent_forward"):
        TI.load_custom_op(so_path, "nonexistent")


def test_custom_op_refuses_a_capture_by_name(so_path, monkeypatch):
    """Under a CUDA-graph capture the host call cannot be recorded: the
    op raises naming itself (the capture is simulated here)."""
    op = TI.load_custom_op(so_path, "sq1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="'sq1'.*CUDA graph"):
        op(torch.ones(2))
