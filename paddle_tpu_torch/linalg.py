"""Dense linear algebra (counterpart: ``paddle_tpu/linalg.py``).

The reference computes these with ``jnp.linalg`` (XLA's decompositions);
the port with ``torch.linalg``, cuSOLVER and cuBLAS on the card, each op
with torch's gradient where the reference has jax's. The reference's
conventions kept:

- ``slogdet`` stacks ``[sign, logabsdet]`` into one tensor;
- ``cholesky_solve(x, y)`` takes the right-hand side first and the factor
  second;
- ``lstsq`` returns ``(solution, residuals, rank, singular values)`` from
  one SVD with the reference's ``rcond`` rule (eps x max(M, N) when None)
  and ``jnp``'s residuals (every column's, whatever the rank and shape);
  ``torch.linalg.lstsq`` on the card has only the ``gels`` driver, which
  returns none of them. No gradient, as in the reference;
- ``matrix_rank(tol=)`` compares the singular values with ``tol`` itself
  (``jnp``'s ``rtol`` argument, which it does not scale); without ``tol``,
  max(s) x max(M, N) x eps. Its result is int32;
- ``pinv(rcond=)`` is torch's ``rtol``;
- ``eig``, ``eigvals``, ``lstsq``, ``matrix_rank`` and ``cond`` record no
  gradient (the reference's ``call_op_nograd``).

SVD, eigh, eig and QR factors are unique only up to signs (phases); the
tests compare them through reconstructions and invariants.
"""
import functools

import torch

from .ops.math import norm, op, tensor_like  # noqa: F401  (norm)

__all__ = [
    "cholesky", "inv", "det", "slogdet", "svd", "eig", "eigh",
    "eigvals", "eigvalsh", "solve", "triangular_solve", "lstsq",
    "matrix_power", "pinv", "qr", "matrix_rank", "norm", "cond",
    "multi_dot", "cholesky_solve",
]


def _t(x):
    return tensor_like(x, None)


def _nograd(fn):
    """An op that records no gradient (the reference's call_op_nograd)."""
    @functools.wraps(fn)
    def body(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)
    return op(body)


@op
def cholesky(x, upper=False):
    return torch.linalg.cholesky(_t(x), upper=upper)


@op
def inv(x):
    return torch.linalg.inv(_t(x))


@op
def det(x):
    return torch.linalg.det(_t(x))


@op
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(_t(x))
    return torch.stack([sign, logabs])


@op
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(_t(x), full_matrices=full_matrices))


@op
def eigh(x, UPLO="L"):
    w, q = torch.linalg.eigh(_t(x), UPLO=UPLO)
    return w, q


@op
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_t(x), UPLO=UPLO)


@_nograd
def eig(x):
    w, q = torch.linalg.eig(_t(x))
    return w, q


@_nograd
def eigvals(x):
    return torch.linalg.eigvals(_t(x))


@op
def solve(x, y):
    return torch.linalg.solve(_t(x), _t(y))


@op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    """``x @ out = y`` (``x.T @ out = y`` with ``transpose``) for a
    triangular ``x`` (scipy's ``solve_triangular``; a 1-D ``y`` is one
    right-hand side)."""
    a, b = _t(x), _t(y)
    if transpose:
        a, upper = a.mT, not upper
    vec = b.dim() == 1
    out = torch.linalg.solve_triangular(
        a, b.unsqueeze(-1) if vec else b, upper=upper,
        unitriangular=unitriangular)
    return out.squeeze(-1) if vec else out


@op
def cholesky_solve(x, y, upper=False):
    """Solve ``A @ out = x`` given ``y``, the Cholesky factor of ``A``. Only
    ``y``'s triangle is read (scipy's ``cho_solve``), so only it gets a
    gradient."""
    b = _t(x)
    vec = b.dim() == 1
    factor = torch.triu(_t(y)) if upper else torch.tril(_t(y))
    out = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, factor,
                               upper=upper)
    return out.squeeze(-1) if vec else out


@_nograd
def lstsq(x, y, rcond=None, driver=None):
    a, b = _t(x), _t(y)
    if a.dim() != 2:
        raise TypeError(f"{a.dim()}-dimensional array given. Array must be "
                        "two-dimensional")
    if b.dim() not in (1, 2):
        raise TypeError(f"{b.dim()}-dimensional array given. Array must be "
                        "one or two-dimensional")
    if a.shape[0] != b.shape[0]:
        raise ValueError("Leading dimensions of input arrays must match")
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    if rcond is None:
        rcond = eps * max(m, n)
    elif rcond < 0:
        rcond = eps
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum().to(torch.int32)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    sol = vt.mT @ (s_inv * (u.mT @ b))
    # jnp's residuals: every column's, whatever the rank and shape
    resid = torch.sum(torch.square(b - a @ sol), dim=0)
    return (sol.reshape(-1) if vec else sol), resid, rank, s


@op
def matrix_power(x, n):
    return torch.linalg.matrix_power(_t(x), n)


@op
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(_t(x), rtol=rcond, hermitian=hermitian)


@op
def qr(x, mode="reduced"):
    """``(Q, R)``; with ``mode="r"``, ``R`` alone."""
    q, r = torch.linalg.qr(_t(x), mode=mode)
    return r if mode == "r" else (q, r)


@_nograd
def matrix_rank(x, tol=None, hermitian=False):
    v = _t(x)
    if not (v.is_floating_point() or v.is_complex()):
        v = v.float()
    if v.dim() < 2:
        return (v != 0).any().to(torch.int32)
    s = torch.linalg.svdvals(v)
    if tol is None:
        cut = s.amax(-1) * max(v.shape[-2:]) * torch.finfo(s.dtype).eps
    else:
        cut = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
    return torch.sum(s > cut.unsqueeze(-1), dim=-1).to(torch.int32)


@_nograd
def cond(x, p=None):
    return torch.linalg.cond(_t(x), p=p)


@op
def multi_dot(xs):
    return torch.linalg.multi_dot([_t(v) for v in xs])
