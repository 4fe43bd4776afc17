"""Flash attention forward (counterpart: ``paddle_tpu/kernels/flash_attention.py``).

The TPU kernel ``_fwd_kernel`` becomes the CUDA kernel in
``csrc/flash_attention_fwd.cu``: online-softmax attention over streamed
64-key tiles, f32 accumulation, O in the input dtype and the per-row
logsumexp in f32. Layout ``[B, S, H, D]`` in and out, as the reference's
``flash_attention_bshd``; the kernel reads q/k/v through their strides, so
no relayout or padding copy is made.

Dispatch: CPU tensors take :func:`flash_attention_fwd_reference`, the
plain PyTorch version of the same function. CUDA tensors launch the kernel
or raise; there is no other path. This slice is forward-only: a CUDA call
that would need a gradient raises ``NotImplementedError``.
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


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_attention_fwd")
    fn = lib.paddle_flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 5 + [i32] * 6 + [i64] * 9
                   + [ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
    lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.paddle_cuda_error_string


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


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q/k/v ``[B, S, H, D]`` -> (O ``[B, S_q, H, D]`` in q's dtype,
    lse ``[B, H, S_q]`` float32). ``scale`` defaults to ``1/sqrt(D)``."""
    _check(q, k, v, causal)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet (they "
            "come with the training slice); run the forward under "
            "torch.no_grad() or torch.inference_mode()")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel is built "
                         f"for {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(strides {t.stride()})")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit "
                         f"{_MAX_GRID_Y}")
    fn, err_str = _kernel()
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, s_q, s_k, d,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 scale, int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0  # kernel launches since the last reset


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q/k/v: [B, S, H, D] -> [B, S, H, D] (the reference's contract)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]


def flash_attention_fwd_reference(q, k, v, causal=False, scale=None):
    """Plain PyTorch version of the kernel: the same 64 x 64 tiling, masks
    and online softmax in float32, on any device. Returns (O in q's dtype,
    lse float32 ``[B, H, S_q]``)."""
    _check(q, k, v, causal)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    qf = q.float().permute(0, 2, 1, 3) * scale  # [B, H, S_q, D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    o = torch.empty((b, h, s_q, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    n_kv_all = -(-s_k // BLOCK_KV)
    for q0 in range(0, s_q, BLOCK_Q):
        qb = qf[:, :, q0:q0 + BLOCK_Q]
        q_pos = torch.arange(q0, q0 + qb.shape[2], device=q.device)
        m = torch.full(qb.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros(qb.shape[:3], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        n_kv = n_kv_all
        if causal:  # key tiles past the diagonal are all masked
            n_kv = min(n_kv, (q0 + BLOCK_Q + BLOCK_KV - 1) // BLOCK_KV)
        for k0 in range(0, n_kv * BLOCK_KV, BLOCK_KV):
            kb = kf[:, :, k0:k0 + BLOCK_KV]
            vb = vf[:, :, k0:k0 + BLOCK_KV]
            s = torch.matmul(qb, kb.transpose(-1, -2))
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            mask = (k_pos < s_k)[None, :]
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
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
