"""``linalg`` against the reference: all 19 functions on the same seeded
float32 inputs (jax runs without 64-bit types), batched where the
reference takes a batch, with the gradients of the differentiable ones.
SVD, eigh, eig and QR are compared through reconstructions and invariants
(their factors are unique only up to signs and phases), and the port's
float64 path against numpy.

Tolerances: float32 results within 2e-4 relative to the largest element
of the result (LAPACK's and torch's factorizations sum in other orders;
the inputs are well conditioned, cond < 50); reconstructions within 1e-4
relative; gradients within 1e-3 relative to their largest element;
float64 within 1e-10. ``lstsq``'s residuals also within 1e-6 absolute: an
exact solution's residual (an underdetermined system's) is float32
rounding noise on both sides.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.linalg as rla
import paddle_tpu_torch.linalg as tla

TOL, REC_TOL, GRAD_TOL, F64_TOL = 2e-4, 1e-4, 1e-3, 1e-10
RESID_FLOOR = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _spd(rng, *batch, n=4):
    a = rng.randn(*batch, n, n).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32))


def _square(rng, *batch, n=4):
    return (rng.randn(*batch, n, n) + 3 * np.eye(n)).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


def _close(got, want, tol=TOL, what="", floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + floor,
                               err_msg=what)


def _both(fn_ref, fn_port, *arrays):
    ref = fn_ref(*[paddle.to_tensor(a) for a in arrays])
    port = fn_port(*[torch.from_numpy(a.copy()) for a in arrays])
    return ref, port


def _grads(fn_ref, fn_port, arrays, pick=lambda o: o):
    """The gradient of sum(pick(out) * w) for a fixed random w, both
    packages."""
    rts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    rout = pick(fn_ref(*rts))
    w = np.asarray(_rng(9).randn(*rout.shape), np.float32)
    (rout * paddle.to_tensor(w)).sum().backward()
    pts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    pout = pick(fn_port(*pts))
    (pout * torch.from_numpy(w)).sum().backward()
    for r, p in zip(rts, pts):
        _close(p.grad.numpy(), np.asarray(r.grad.numpy()), GRAD_TOL)


SIMPLE = {  # name: (inputs builder, call)
    "cholesky": (lambda r: [_spd(r, 2)], lambda L, a: L.cholesky(a)),
    "cholesky_upper": (lambda r: [_spd(r, 2)],
                       lambda L, a: L.cholesky(a, upper=True)),
    "inv": (lambda r: [_square(r, 2)], lambda L, a: L.inv(a)),
    "det": (lambda r: [_square(r, 3)], lambda L, a: L.det(a)),
    "slogdet": (lambda r: [_square(r, 3)], lambda L, a: L.slogdet(a)),
    "eigvalsh": (lambda r: [_spd(r, 2)], lambda L, a: L.eigvalsh(a)),
    "eigvalsh_upper": (lambda r: [_spd(r, 2)],
                       lambda L, a: L.eigvalsh(a, UPLO="U")),
    "solve": (lambda r: [_square(r, 2), r.randn(2, 4, 3).astype(np.float32)],
              lambda L, a, b: L.solve(a, b)),
    "triangular_solve": (
        lambda r: [np.triu(_square(r)), r.randn(4, 2).astype(np.float32)],
        lambda L, a, b: L.triangular_solve(a, b)),
    "triangular_solve_lower_t_unit": (
        lambda r: [np.tril(_square(r)), r.randn(4, 2).astype(np.float32)],
        lambda L, a, b: L.triangular_solve(a, b, upper=False, transpose=True,
                                           unitriangular=True)),
    "cholesky_solve": (
        lambda r: [r.randn(4, 2).astype(np.float32),
                   np.linalg.cholesky(_spd(r)).astype(np.float32)],
        lambda L, b, f: L.cholesky_solve(b, f)),
    "cholesky_solve_upper": (
        lambda r: [r.randn(4, 2).astype(np.float32),
                   np.linalg.cholesky(_spd(r)).T.copy()],
        lambda L, b, f: L.cholesky_solve(b, f, upper=True)),
    "matrix_power": (lambda r: [_square(r, 2) / 3],
                     lambda L, a: L.matrix_power(a, 3)),
    "matrix_power_neg": (lambda r: [_square(r)],
                         lambda L, a: L.matrix_power(a, -2)),
    "pinv": (lambda r: [r.randn(2, 5, 3).astype(np.float32)],
             lambda L, a: L.pinv(a)),
    "norm": (lambda r: [r.randn(3, 4).astype(np.float32)],
             lambda L, a: L.norm(a)),
    "cond": (lambda r: [_square(r, 2)], lambda L, a: L.cond(a)),
    "cond_fro": (lambda r: [_square(r)], lambda L, a: L.cond(a, p="fro")),
    "multi_dot": (lambda r: [r.randn(3, 4).astype(np.float32),
                             r.randn(4, 5).astype(np.float32),
                             r.randn(5, 2).astype(np.float32)],
                  lambda L, *m: L.multi_dot(list(m))),
}
DIFFERENTIABLE = ["cholesky", "inv", "det", "slogdet", "solve",
                  "triangular_solve", "cholesky_solve", "matrix_power",
                  "pinv", "norm", "multi_dot"]


@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_matches_the_reference(name):
    build, call = SIMPLE[name]
    arrays = build(_rng(1))
    ref, port = _both(lambda *a: call(rla, *a), lambda *a: call(tla, *a),
                      *arrays)
    _close(_np(port), _np(ref), what=name)


@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_gradients_match_the_reference(name):
    build, call = SIMPLE[name]
    _grads(lambda *a: call(rla, *a), lambda *a: call(tla, *a),
           build(_rng(2)))


def test_svd_eigh_qr_reconstruct_and_agree_in_invariants():
    a = _rng(3).randn(2, 5, 3).astype(np.float32)
    (ru, rs, rv), (u, s, v) = _both(rla.svd, tla.svd, a)
    _close(_np(s), _np(rs), what="singular values")
    rec = _np(u) @ (_np(s)[..., None] * _np(v))
    _close(rec, a, REC_TOL, "U S Vh")
    assert _np(u).shape == _np(ru).shape and _np(v).shape == _np(rv).shape
    full = tla.svd(torch.from_numpy(a), full_matrices=True)
    assert tuple(full[0].shape) == (2, 5, 5)

    spd = _spd(_rng(4), 2)
    (rw, _), (w, q) = _both(rla.eigh, tla.eigh, spd)
    _close(_np(w), _np(rw), what="eigh values")
    q = _np(q)
    _close(q @ (_np(w)[..., None] * np.swapaxes(q, -1, -2)), spd, REC_TOL,
           "Q diag(w) Qt")

    m = _rng(5).randn(2, 5, 3).astype(np.float32)
    for mode, shape in (("reduced", (2, 5, 3)), ("complete", (2, 5, 5))):
        (rq, rr), (q, r) = _both(lambda x: rla.qr(x, mode=mode),
                                 lambda x: tla.qr(x, mode=mode), m)
        q, r = _np(q), _np(r)
        assert q.shape == shape and q.shape == _np(rq).shape
        _close(q @ r, m, REC_TOL, f"QR {mode}")
        _close(np.abs(r), np.abs(_np(rr)), what=f"|R| {mode}")
    r_only = _np(tla.qr(torch.from_numpy(m), mode="r"))
    _close(np.abs(r_only), np.abs(_np(rr)[..., :3, :]), what="mode r")


def test_eig_and_eigvals_without_gradient():
    a = _square(_rng(6))
    (rw, _), (w, v) = _both(rla.eig, tla.eig, a)
    w, v = _np(w), _np(v)
    key = lambda z: np.lexsort((np.round(z.imag, 4), np.round(z.real, 4)))
    _close(w[key(w)], _np(rw)[key(_np(rw))], what="eigenvalues")
    _close(a.astype(np.complex64) @ v, v * w[None, :], REC_TOL, "A V = V w")
    vals = _np(tla.eigvals(torch.from_numpy(a)))
    _close(vals[key(vals)], w[key(w)], what="eigvals")
    t = torch.from_numpy(a).requires_grad_(True)
    assert not tla.eig(t)[0].requires_grad
    assert not tla.eigvals(t).requires_grad


@pytest.mark.parametrize("shape,rcond", [((6, 3), None), ((3, 5), None),
                                         ((6, 3), 0.5)])
def test_lstsq_numpy_fields(shape, rcond):
    rng = _rng(7)
    a = rng.randn(*shape).astype(np.float32)
    if rcond is not None:
        a[:, 2] = a[:, 0] * 1e-3  # a tiny singular value under rcond
    b = rng.randn(shape[0], 2).astype(np.float32)
    ref = rla.lstsq(paddle.to_tensor(a), paddle.to_tensor(b), rcond=rcond)
    port = tla.lstsq(torch.from_numpy(a), torch.from_numpy(b), rcond=rcond)
    for name, r, p in zip(("solution", "residuals", "rank", "sv"), ref,
                          port):
        _close(_np(p), _np(r), what=name,
               floor=RESID_FLOOR if name == "residuals" else 0.0)
    assert _np(port[2]).dtype == np.int32
    vec = tla.lstsq(torch.from_numpy(a), torch.from_numpy(b[:, 0]))
    assert tuple(vec[0].shape) == (shape[1],)


def test_matrix_rank_tol_is_the_reference_rtol():
    a = _rng(8).randn(2, 5, 4).astype(np.float32)
    a[0, :, 3] = a[0, :, 0]
    for tol in (None, 1e-3, 2.0):
        ref = rla.matrix_rank(paddle.to_tensor(a), tol=tol)
        port = tla.matrix_rank(torch.from_numpy(a), tol=tol)
        np.testing.assert_array_equal(_np(port), _np(ref))
        assert _np(port).dtype == np.int32


def test_float64_against_numpy():
    rng = _rng(10)
    a = rng.randn(3, 4, 4) + 4 * np.eye(4)
    b = rng.randn(3, 4, 2)
    t = torch.from_numpy(a)
    _close(tla.inv(t).numpy(), np.linalg.inv(a), F64_TOL)
    _close(tla.solve(t, torch.from_numpy(b)).numpy(),
           np.linalg.solve(a, b), F64_TOL)
    _close(tla.det(t).numpy(), np.linalg.det(a), F64_TOL)
    sign, logabs = np.linalg.slogdet(a)
    _close(tla.slogdet(t).numpy(), np.stack([sign, logabs]), F64_TOL)
    assert tla.inv(t).dtype == torch.float64
