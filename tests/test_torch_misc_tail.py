"""``ops/misc_tail.py`` against the reference: all 16 functions on the
same seeded numpy inputs, the differentiable ones with their gradients,
exported at the top level as the reference exports them. ``sampling_id``
draws from different generators in the two packages (threefry against
Philox), so both are given the reference's uniforms; the port's seeded
draws repeat and its output stays in range.

Tolerances: integer results, masks and the host ops exact; float32
results and gradients within 1e-5 relative to their largest element (the
same float32 math in another order).
"""
import io

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.misc_tail as R
import paddle_tpu_torch as pt
import paddle_tpu_torch.ops.misc_tail as T

TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


def _close(got, want, what="", tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _exact(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _grad_case(name, ref_fn, port_fn, arrays):
    """Outputs and the gradients of sum(out * w) for every input."""
    rts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    rout = ref_fn(*rts)
    w = np.random.RandomState(11).randn(*rout.shape).astype(np.float32)
    (rout * paddle.to_tensor(w)).sum().backward()
    pts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    pout = port_fn(*pts)
    (pout * torch.from_numpy(w)).sum().backward()
    _close(pout.detach(), rout, name)
    for i, (r, p) in enumerate(zip(rts, pts)):
        _close(p.grad, r.grad, f"{name} grad {i}")


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


GRAD_CASES = {
    "diag_embed": (lambda rng: [_f32(rng, 2, 3)],
                   lambda M, x: M.diag_embed(x, offset=1, dim1=0, dim2=2)),
    "diag_embed_neg": (lambda rng: [_f32(rng, 2, 3)],
                       lambda M, x: M.diag_embed(x, offset=-2)),
    "bilinear_tensor_product": (
        lambda rng: [_f32(rng, 4, 3), _f32(rng, 4, 5), _f32(rng, 2, 3, 5),
                     _f32(rng, 1, 2)],
        lambda M, x, y, w, b: M.bilinear_tensor_product(x, y, w, b)),
    "add_position_encoding": (
        lambda rng: [_f32(rng, 2, 5, 6)],
        lambda M, x: M.add_position_encoding(x, alpha=0.5, beta=2.0)),
    "batch_fc": (lambda rng: [_f32(rng, 3, 4, 5), _f32(rng, 3, 5, 2),
                              _f32(rng, 3, 1, 2)],
                 lambda M, x, w, b: M.batch_fc(x, w, b)),
    "polygon_box_transform": (
        lambda rng: [_f32(rng, 2, 4, 3, 5)],
        lambda M, x: M.polygon_box_transform(x)),
    "correlation": (lambda rng: [_f32(rng, 2, 3, 6, 7), _f32(rng, 2, 3, 6, 7)],
                    lambda M, a, b: M.correlation(a, b, 2, 1, 2, 1, 1)),
    "correlation_strided": (
        lambda rng: [_f32(rng, 1, 2, 8, 8), _f32(rng, 1, 2, 8, 8)],
        lambda M, a, b: M.correlation(a, b, 4, 1, 4, stride1=2, stride2=2)),
    "match_matrix_tensor": (
        lambda rng: [_f32(rng, 2, 3, 4), _f32(rng, 2, 5, 6),
                     _f32(rng, 4, 2, 6)],
        lambda M, x, y, w: M.match_matrix_tensor(x, y, w)[0]),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_differentiable_ops_match_the_reference(name):
    build, call = GRAD_CASES[name]
    _grad_case(name, lambda *a: call(R, *a), lambda *a: call(T, *a),
               build(np.random.RandomState(1)))


def test_sequence_topk_avg_pooling_matches_with_gradient():
    rng = np.random.RandomState(2)
    x = _f32(rng, 3, 2, 7)
    lens = np.array([7, 3, 1], np.int64)
    _grad_case("sequence_topk_avg_pooling",
               lambda v: R.sequence_topk_avg_pooling(
                   v, paddle.to_tensor(lens), [1, 3, 5]),
               lambda v: T.sequence_topk_avg_pooling(
                   v, torch.from_numpy(lens), [1, 3, 5]), [x])


def test_match_matrix_tensor_mask():
    rng = np.random.RandomState(3)
    x, y, w = _f32(rng, 2, 3, 4), _f32(rng, 2, 5, 6), _f32(rng, 4, 2, 6)
    xl, yl = np.array([3, 1]), np.array([2, 5])
    _, rmask = R.match_matrix_tensor(
        paddle.to_tensor(x), paddle.to_tensor(y), paddle.to_tensor(w),
        paddle.to_tensor(xl), paddle.to_tensor(yl))
    _, tmask = T.match_matrix_tensor(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        torch.from_numpy(xl), torch.from_numpy(yl))
    _exact(tmask, rmask)
    _, full = T.match_matrix_tensor(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(w))
    assert bool(torch.all(full == 1))


def test_mean_iou_and_shard_index_exact():
    rng = np.random.RandomState(4)
    pred = rng.randint(0, 5, (6, 7)).astype(np.int64)
    lab = rng.randint(0, 5, (6, 7)).astype(np.int64)
    ref = R.mean_iou(paddle.to_tensor(pred), paddle.to_tensor(lab), 6)
    got = T.mean_iou(torch.from_numpy(pred), torch.from_numpy(lab), 6)
    _close(got[0], ref[0], "mean_iou")
    _exact(got[1], ref[1], "wrong")
    _exact(got[2], ref[2], "correct")
    ids = rng.randint(0, 20, (4, 3)).astype(np.int64)
    for shard in range(3):
        _exact(T.shard_index(torch.from_numpy(ids), 20, 3, shard),
               R.shard_index(paddle.to_tensor(ids), 20, 3, shard), "shard")
    with pytest.raises(ValueError, match="shard_id"):
        T.shard_index(torch.from_numpy(ids), 20, 3, 3)


@pytest.mark.parametrize("scheme,types,seq", [
    ("IOB", 3, True), ("IOE", 2, False), ("IOBES", 2, True),
    ("plain", 4, False)])
def test_chunk_eval_matches(scheme, types, seq):
    rng = np.random.RandomState(5)
    per = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    hi = types * per + 1
    inp = rng.randint(0, hi, (4, 12)).astype(np.int64)
    lab = rng.randint(0, hi, (4, 12)).astype(np.int64)
    lens = np.array([12, 9, 5, 1], np.int64) if seq else None
    kw = dict(excluded_chunk_types=[1])
    ref = R.chunk_eval(paddle.to_tensor(inp), paddle.to_tensor(lab), scheme,
                       types, seq_length=lens, **kw)
    got = T.chunk_eval(torch.from_numpy(inp), torch.from_numpy(lab), scheme,
                       types, seq_length=lens, **kw)
    for r, g in zip(ref, got):
        _exact(g, r, scheme)
        assert g.device.type == "cpu"
    with pytest.raises(ValueError, match="chunk_scheme"):
        T.chunk_eval(torch.from_numpy(inp), torch.from_numpy(lab), "BIO", 2)


def test_positive_negative_pair_and_similarity_focus():
    rng = np.random.RandomState(6)
    score = rng.rand(12).astype(np.float32)
    score[3] = score[4]  # a tie
    label = rng.randint(0, 3, 12).astype(np.float32)
    qid = rng.randint(0, 3, 12).astype(np.int64)
    ref = R.positive_negative_pair(paddle.to_tensor(score),
                                   paddle.to_tensor(label),
                                   paddle.to_tensor(qid))
    got = T.positive_negative_pair(torch.from_numpy(score),
                                   torch.from_numpy(label),
                                   torch.from_numpy(qid))
    for r, g in zip(ref, got):
        _exact(g, r, "positive_negative_pair")
    x = _f32(rng, 2, 3, 4, 5)
    for axis, idx in ((1, [0, 2]), (2, [3]), (3, [1, 4])):
        _exact(T.similarity_focus(torch.from_numpy(x), axis, idx),
               R.similarity_focus(paddle.to_tensor(x), axis, idx),
               f"similarity_focus axis {axis}")
    with pytest.raises(ValueError, match="out of range"):
        T.similarity_focus(torch.from_numpy(x), 1, [-1])


def test_sampling_id_given_the_reference_uniforms():
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(7)
    p = rng.rand(16, 6).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    seed, lo, hi = 5, 0.1, 0.9
    want = R.sampling_id(paddle.to_tensor(p), min=lo, max=hi, seed=seed)
    u = jax.random.uniform(jax.random.PRNGKey(seed), (16,), jnp.float32,
                           minval=lo, maxval=hi)
    got = T._sample_ids(torch.from_numpy(p), torch.from_numpy(np.asarray(u)))
    _exact(got, want, "sampling_id")
    a = T.sampling_id(torch.from_numpy(p), seed=3)
    b = T.sampling_id(torch.from_numpy(p), seed=3)
    _exact(a, b, "seeded draws repeat")
    assert int(a.min()) >= 0 and int(a.max()) < 6
    pt.seed(1)
    c = T.sampling_id(torch.from_numpy(p))
    assert tuple(c.shape) == (16,) and c.dtype == torch.int64


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    img = (np.random.RandomState(8).rand(6, 5, 3) * 255).astype(np.uint8)
    path = tmp_path / "x.jpg"
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    path.write_bytes(buf.getvalue())
    raw_ref = R.read_file(str(path))
    raw = T.read_file(str(path))
    _exact(raw, raw_ref, "bytes")
    assert raw.device.type == "cpu" and raw.dtype == torch.uint8
    for mode in ("unchanged", "gray", "rgb"):
        _exact(T.decode_jpeg(raw, mode=mode),
               R.decode_jpeg(raw_ref, mode=mode), mode)


def test_decode_jpeg_names_pil_when_it_is_missing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        T.decode_jpeg(torch.zeros(4, dtype=torch.uint8))


def test_exported_at_the_top_level_as_the_reference():
    for name in T.__all__:
        assert getattr(pt, name) is getattr(T, name)
        assert getattr(pt.ops, name) is getattr(T, name)
        assert hasattr(paddle, name)
    out = pt.diag_embed(pt.to_tensor(np.ones((2, 2), np.float32),
                                     place="cpu"))
    assert isinstance(out, pt.Tensor) and tuple(out.shape) == (2, 2, 2)
