"""Flash attention (counterpart: ``paddle_tpu/kernels/flash_attention.py``).

The three TPU kernels become CUDA kernels:

- ``_fwd_kernel`` -> ``csrc/flash_attention_fwd.cu``
  (:func:`flash_attention_fwd`): online-softmax attention over streamed
  64-key tiles, f32 accumulation, O in the input dtype and the per-row
  logsumexp in f32;
- ``_bwd_dq_kernel`` -> ``csrc/flash_attention_bwd.cu``
  (:func:`flash_attention_bwd_dq`): dQ per 64-row query tile;
- ``_bwd_dkv_kernel`` -> the same source (:func:`flash_attention_bwd_dkv`):
  dK and dV per 64-row key tile.

:class:`FlashAttention` is the ``torch.autograd.Function`` around them (the
reference's ``custom_vjp``): it saves (q, k, v, O, lse) and its backward runs
:func:`flash_attention_bwd`. Layout ``[B, S, H, D]`` in and out, as the
reference's ``flash_attention_bshd``; the kernels read q/k/v/dO through
their strides, so no relayout or padding copy is made.

Dispatch: CPU tensors take the plain PyTorch versions
(:func:`flash_attention_fwd_reference`, :func:`flash_attention_bwd_reference`)
with the same 64 x 64 tiles and masks. CUDA tensors launch the kernels or
raise; there is no other path. Each kernel wrapper counts its launches in
its ``launches`` attribute.
"""
import ctypes
import functools

import torch

from . import _build

BLOCK_Q = 64
BLOCK_KV = 64
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind(lib, name, n_ptr, n_strides):
    fn = getattr(lib, name)
    fn.argtypes = ([_PTR] * n_ptr + [_I32] * 6 + [_I64] * n_strides
                   + [ctypes.c_float, _I32, _PTR])
    fn.restype = ctypes.c_int
    return fn


def _error_string(lib):
    lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
    lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib.paddle_cuda_error_string


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    lib = _build.load("flash_attention_fwd")
    return (_bind(lib, "paddle_flash_attention_fwd", 5, 9),
            _error_string(lib))


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    lib = _build.load("flash_attention_bwd")
    return (_bind(lib, "paddle_flash_attention_bwd_dq", 7, 12),
            _bind(lib, "paddle_flash_attention_bwd_dkv", 8, 12),
            _error_string(lib))


def _check(q, k, v, causal):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D [B, S, H, D] tensor")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree on B, H and D")
    if s_q == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if causal and s_q != k.shape[1]:
        raise NotImplementedError(
            "causal flash attention requires s_q == s_k (top-left aligned "
            "mask); bottom-right cache alignment is not implemented")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def _check_bwd(q, k, v, do, lse, delta, causal):
    _check(q, k, v, causal)
    b, s_q, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} must have q's "
                         f"shape {tuple(q.shape)}, dtype and device")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, s_q) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{name} must be float32 [B, H, S_q] = "
                             f"{(b, h, s_q)} on q's device, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / (d ** 0.5)


def _check_cuda(tensors, b, h, d, dtype):
    """What the CUDA kernels take; raises on anything else."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernels are "
                         f"built for {HEAD_DIMS}")
    for name, t in tensors.items():
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(strides {t.stride()})")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit "
                         f"{_MAX_GRID_Y}")


def _device_of(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _launch(name, fn, err_str, device, args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(err).decode()} "
                           f"(cudaError {err})")


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q/k/v ``[B, S, H, D]`` -> (O ``[B, S_q, H, D]`` in q's dtype,
    lse ``[B, H, S_q]`` float32). ``scale`` defaults to ``1/sqrt(D)``.
    No autograd: differentiable callers go through :class:`FlashAttention`
    (:func:`flash_attention_bshd`)."""
    _check(q, k, v, causal)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = _scale(scale, d)
    if _device_of(q) == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd launches the kernel outside autograd; "
            "call flash_attention_bshd (the FlashAttention Function) for "
            "a differentiable result")
    _check_cuda({"q": q, "k": k, "v": v}, b, h, d, q.dtype)
    fn, err_str = _fwd_kernel()
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", fn, err_str, q.device,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, s_q, s_k, d,
             *_strides(q, k, v), scale, int(bool(causal))])
    flash_attention_fwd.launches += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, causal, scale):
    b, s_q, h, d = q.shape
    return [lse.data_ptr(), delta.data_ptr()], [
        _DTYPE_CODES[q.dtype], b, h, s_q, k.shape[1], d,
        *_strides(q, k, v, do), scale, int(bool(causal))]


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """dQ ``[B, S_q, H, D]`` in q's dtype from q/k/v/dO ``[B, S, H, D]``,
    the forward's lse and ``delta = rowsum(O * dO)`` (both float32
    ``[B, H, S_q]``)."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    b, s_q, h, d = q.shape
    scale = _scale(scale, d)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                causal, scale)
    _check_cuda({"q": q, "k": k, "v": v, "dO": do}, b, h, d, q.dtype)
    lse, delta = lse.contiguous(), delta.contiguous()
    fn, _, err_str = _bwd_kernels()
    dq = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    ptrs, rest = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    _launch("flash_attention_bwd_dq", fn, err_str, q.device,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *ptrs,
             dq.data_ptr(), *rest])
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """(dK, dV), each ``[B, S_k, H, D]`` in the input dtype, from the same
    inputs as :func:`flash_attention_bwd_dq`."""
    _check_bwd(q, k, v, do, lse, delta, causal)
    b, _, h, d = q.shape
    s_k = k.shape[1]
    scale = _scale(scale, d)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
    _check_cuda({"q": q, "k": k, "v": v, "dO": do}, b, h, d, q.dtype)
    lse, delta = lse.contiguous(), delta.contiguous()
    _, fn, err_str = _bwd_kernels()
    dk = torch.empty((b, s_k, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s_k, h, d), dtype=v.dtype, device=v.device)
    ptrs, rest = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    _launch("flash_attention_bwd_dkv", fn, err_str, q.device,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), *ptrs,
             dk.data_ptr(), dv.data_ptr(), *rest])
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0  # kernel launches since the last reset
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def attention_delta(o, do):
    """``rowsum(O * dO)`` in float32, ``[B, H, S_q]`` (the reference's
    ``delta``, computed outside its kernels as here)."""
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """(dQ, dK, dV) of the attention that gave (O, lse), for the output
    gradient ``do``: the reference's ``_flash_bwd``."""
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the backward kernels as its gradient (the
    reference's ``custom_vjp``). Saves (q, k, v, O, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q/k/v: [B, S, H, D] -> [B, S, H, D] (the reference's contract),
    differentiable through :class:`FlashAttention` on every device."""
    _check(q, k, v, causal)
    return FlashAttention.apply(q, k, v, bool(causal),
                                _scale(scale, q.shape[3]))


def _heads_first(*tensors):
    """[B, S, H, D] -> float32 [B, H, S, D]."""
    return [t.float().permute(0, 2, 1, 3) for t in tensors]


def _kv_tiles(s_k, q0, causal):
    """Key-tile starts a query tile at ``q0`` visits (causal: up to the
    diagonal tile)."""
    n_kv = -(-s_k // BLOCK_KV)
    if causal:
        n_kv = min(n_kv, (q0 + BLOCK_Q + BLOCK_KV - 1) // BLOCK_KV)
    return range(0, n_kv * BLOCK_KV, BLOCK_KV)


def _mask(q_pos, k_pos, s_k, causal):
    mask = (k_pos < s_k)[None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return mask


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch version of the forward kernel: the same 64 x 64
    tiling, masks and online softmax in float32, on any device. Returns
    (O in q's dtype, lse float32 ``[B, H, S_q]``)."""
    _check(q, k, v, causal)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    qf, kf, vf = _heads_first(q, k, v)
    qf = qf * _scale(scale, d)
    o = torch.empty((b, h, s_q, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    for q0 in range(0, s_q, BLOCK_Q):
        qb = qf[:, :, q0:q0 + BLOCK_Q]
        q_pos = torch.arange(q0, q0 + qb.shape[2], device=q.device)
        m = torch.full(qb.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros(qb.shape[:3], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        for k0 in _kv_tiles(s_k, q0, causal):
            kb = kf[:, :, k0:k0 + BLOCK_KV]
            vb = vf[:, :, k0:k0 + BLOCK_KV]
            s = torch.matmul(qb, kb.transpose(-1, -2))
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            mask = _mask(q_pos, k_pos, s_k, causal)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vb)
            m = m_new
        l_safe = l.clamp_min(1e-30)
        o[:, :, q0:q0 + BLOCK_Q] = acc / l_safe[..., None]
        lse[:, :, q0:q0 + BLOCK_Q] = m + torch.log(l_safe)
    return o.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                     scale):
    """Plain version of the dQ kernel: per 64-row query tile, recompute
    P = exp(S - lse) over the key tiles up to the diagonal and accumulate
    dS.K, dS = P * (dO.V^T - delta); dQ = scale * sum."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    qf, kf, vf, dof = _heads_first(q, k, v, do)
    qf = qf * scale
    dq = torch.empty((b, h, s_q, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s_q, BLOCK_Q):
        qb = qf[:, :, q0:q0 + BLOCK_Q]
        dob = dof[:, :, q0:q0 + BLOCK_Q]
        lb = lse[:, :, q0:q0 + BLOCK_Q, None]
        db = delta[:, :, q0:q0 + BLOCK_Q, None]
        q_pos = torch.arange(q0, q0 + qb.shape[2], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        for k0 in _kv_tiles(s_k, q0, causal):
            kb = kf[:, :, k0:k0 + BLOCK_KV]
            vb = vf[:, :, k0:k0 + BLOCK_KV]
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = torch.matmul(qb, kb.transpose(-1, -2))
            p = torch.where(_mask(q_pos, k_pos, s_k, causal),
                            torch.exp(s - lb), 0.0)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            acc = acc + torch.matmul(p * (dp - db), kb)
        dq[:, :, q0:q0 + BLOCK_Q] = acc * scale
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                      scale):
    """Plain version of the dK/dV kernel: per 64-row key tile, loop over the
    query tiles from the causal start and accumulate P^T.dO and
    dS^T.(scale * Q)."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    qf, kf, vf, dof = _heads_first(q, k, v, do)
    qf = qf * scale
    dk = torch.empty((b, h, s_k, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, h, s_k, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, s_k, BLOCK_KV):
        kb = kf[:, :, k0:k0 + BLOCK_KV]
        vb = vf[:, :, k0:k0 + BLOCK_KV]
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
        dk_acc = torch.zeros(kb.shape, device=q.device)
        dv_acc = torch.zeros(kb.shape, device=q.device)
        start = (k0 // BLOCK_Q) * BLOCK_Q if causal else 0
        for q0 in range(start, s_q, BLOCK_Q):
            qb = qf[:, :, q0:q0 + BLOCK_Q]
            dob = dof[:, :, q0:q0 + BLOCK_Q]
            q_pos = torch.arange(q0, q0 + qb.shape[2], device=q.device)
            s = torch.matmul(qb, kb.transpose(-1, -2))
            p = torch.where(_mask(q_pos, k_pos, s_k, causal),
                            torch.exp(s - lse[:, :, q0:q0 + BLOCK_Q, None]),
                            0.0)
            dv_acc = dv_acc + torch.matmul(p.transpose(-1, -2), dob)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - delta[:, :, q0:q0 + BLOCK_Q, None])
            dk_acc = dk_acc + torch.matmul(ds.transpose(-1, -2), qb)
        dk[:, :, k0:k0 + BLOCK_KV] = dk_acc
        dv[:, :, k0:k0 + BLOCK_KV] = dv_acc
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  scale=None):
    """Plain PyTorch version of the backward (both kernels), blockwise with
    the same 64 x 64 tiles and masks, float32 math, on any device."""
    delta = attention_delta(o, do)
    _check_bwd(q, k, v, do, lse, delta, causal)
    scale = _scale(scale, q.shape[3])
    args = (q, k, v, do, lse, delta, causal, scale)
    return (flash_attention_bwd_dq_reference(*args),
            *flash_attention_bwd_dkv_reference(*args))
