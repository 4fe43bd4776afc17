"""Flash attention (counterpart: ``paddle_tpu/kernels/flash_attention.py``).

The three TPU kernels become CUDA kernels, chosen by the input dtype
(:func:`_variant`):

- ``_fwd_kernel`` -> :func:`flash_attention_fwd`: for bfloat16,
  ``csrc/flash_attention_fwd_sm90.cu`` (``wgmma`` tensor cores, TMA-staged
  K/V); for float32, ``csrc/flash_attention_fwd.cu`` (f32 on the CUDA
  cores). Online-softmax attention, O in the input dtype and the per-row
  logsumexp in f32;
- ``_bwd_dq_kernel`` and the Delta before it -> :func:`flash_attention_bwd_dq`:
  for bfloat16, ``csrc/flash_attention_bwd_dq_sm90.cu`` (tensor cores, Delta
  computed in the kernel and written out); for float32, the dQ kernel of
  ``csrc/flash_attention_bwd.cu`` with Delta from :func:`attention_delta`.
  Both return ``(dq, delta)``;
- ``_bwd_dkv_kernel`` -> :func:`flash_attention_bwd_dkv`, which takes the
  Delta that dQ returned: for bfloat16,
  ``csrc/flash_attention_bwd_dkv_sm90.cu`` (tensor cores, the score tiles
  computed transposed); for float32, the dK/dV kernel of
  ``csrc/flash_attention_bwd.cu``.

float32 stays off the tensor cores because they would run it as TF32
(about three decimal digits). :data:`KERNELS` is the one table of which
library and entry point each wrapper launches for each variant.

:class:`FlashAttention` is the ``torch.autograd.Function`` around them (the
reference's ``custom_vjp``): it saves (q, k, v, O, lse) and its backward runs
:func:`flash_attention_bwd`. Layout ``[B, S, H, D]`` in and out, as the
reference's ``flash_attention_bshd``; the kernels read q/k/v/dO through
their strides, so no relayout or padding copy is made.

Dispatch: CPU tensors take the plain PyTorch versions
(:func:`flash_attention_fwd_reference`, :func:`flash_attention_bwd_reference`)
with the same 64 x 64 tiles and masks. CUDA tensors launch the kernels or
raise; there is no other path. Each kernel wrapper counts its launches in
its ``launches`` attribute and, by dtype variant (``"bf16"``,
``"float32"``), in ``variant_launches``.

The forward is the torch operator ``paddle_tpu_torch::flash_attention_fwd``
(:data:`flash_attention_fwd_op`): its CPU implementation is the plain
version, its CUDA implementation the kernel launch, and its fake
implementation gives the output shapes, so ``torch.export`` records it as
one node and an exported program runs it in a process that imports this
module. Eager calls, captured CUDA graphs and exported programs all go
through it. An exported program cannot re-route at run time, so the
gate (:func:`supports`) reads only shapes, dtypes and strides; a bfloat16
input whose base address is off 16 bytes (which TMA cannot load) is copied
into fresh storage at launch and counted in ``flash_attention_fwd.realigned``.

Each entry point (:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`,
:func:`flash_attention_bwd_dkv`, so :class:`FlashAttention` too) reports
its call to the op observers (``core.dispatch``) as one op under the
reference's kernel name; with no observer registered that costs one
global read (``_dispatch._OBSERVER_LIST``).
"""
import ctypes
import functools

import torch

from ..core import dispatch as _dispatch
from . import _build

BLOCK_Q = 64
BLOCK_KV = 64
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {torch.bfloat16: "bf16", torch.float32: "float32"}
# each kernel's CUDA function name (as a device trace shows it) -> the
# reference's name for the kernel
CUDA_FUNCTIONS = {
    "flash_fwd_sm90_kernel": "flash_attention_fwd",
    "flash_fwd_kernel": "flash_attention_fwd",
    "flash_bwd_dq_sm90_kernel": "flash_attention_bwd_dq",
    "flash_bwd_dq_kernel": "flash_attention_bwd_dq",
    "flash_bwd_dkv_sm90_kernel": "flash_attention_bwd_dkv",
    "flash_bwd_dkv_kernel": "flash_attention_bwd_dkv"}
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


# (library ``csrc/<name>.cu``, C entry point, pointer and stride argument
# counts) that each kernel wrapper launches, by variant (:func:`_variant`).
KERNELS = {
    ("flash_attention_fwd", "tensor_core"):
        ("flash_attention_fwd_sm90", "paddle_flash_attention_fwd_sm90", 5, 9),
    ("flash_attention_fwd", "cuda_core"):
        ("flash_attention_fwd", "paddle_flash_attention_fwd", 5, 9),
    ("flash_attention_bwd_dq", "tensor_core"):
        ("flash_attention_bwd_dq_sm90", "paddle_flash_attention_bwd_dq_sm90",
         8, 15),
    ("flash_attention_bwd_dq", "cuda_core"):
        ("flash_attention_bwd", "paddle_flash_attention_bwd_dq", 7, 12),
    ("flash_attention_bwd_dkv", "tensor_core"):
        ("flash_attention_bwd_dkv_sm90",
         "paddle_flash_attention_bwd_dkv_sm90", 8, 12),
    ("flash_attention_bwd_dkv", "cuda_core"):
        ("flash_attention_bwd", "paddle_flash_attention_bwd_dkv", 8, 12),
}


@functools.lru_cache(maxsize=None)
def _kernel(wrapper, variant):
    """(the bound C entry point, the library's error-string function) of
    ``KERNELS[wrapper, variant]``, built at first use."""
    library, entry, n_ptr, n_strides = KERNELS[wrapper, variant]
    lib = _build.load(library)
    return _bind(lib, entry, n_ptr, n_strides), _error_string(lib)


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
        if t is None:
            continue
        if (t.shape != (b, h, s_q) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{name} must be float32 [B, H, S_q] = "
                             f"{(b, h, s_q)} on q's device, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / (d ** 0.5)


def _variant(dtype, head_dim):
    """Which CUDA kernels take inputs of ``dtype``: ``"tensor_core"``
    (bfloat16: the sm90 ``wgmma`` forward, dQ and dK/dV kernels) or
    ``"cuda_core"`` (float32: f32 on the CUDA cores, which the tensor cores
    would round to TF32); :data:`KERNELS` maps each to its library. Raises
    on anything neither takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not supported; the kernels "
                         f"are built for {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "tensor_core"
    if dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"flash attention takes float32 or bfloat16, got {dtype}")


def _check_cuda(tensors, b, h, d, dtype):
    """What the CUDA kernels take; raises on anything else. Returns the
    variant (:func:`_variant`)."""
    variant = _variant(dtype, d)
    for name, t in tensors.items():
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(strides {t.stride()})")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid limit "
                         f"{_MAX_GRID_Y}")
    if variant == "tensor_core":
        _check_tma(tensors)
    return variant


def _check_tma(tensors):
    """The tensor-core kernels load through TMA: every base address and
    every batch, seq and head stride must be a multiple of 16 bytes."""
    for name, t in tensors.items():
        esize = t.element_size()
        if t.data_ptr() % 16 or any(s * esize % 16 for s in t.stride()[:3]):
            raise ValueError(
                f"{name} needs a 16-byte aligned base and batch/seq/head "
                f"strides that are multiples of 16 bytes for the TMA loads "
                f"(address {t.data_ptr():#x}, strides {t.stride()})")


def supports(q, k, v):
    """True when the CUDA kernels take q/k/v ``[B, S, H, D]``: one dtype,
    float32 or bfloat16; head dim in :data:`HEAD_DIMS`; a contiguous head
    dim; B*H within the grid limit; for bfloat16 (TMA loads) batch/seq/head
    strides that are multiples of 16 bytes. Reads shapes, dtypes and
    strides only, never an address, so it holds under ``torch.export``'s
    fake tensors (a symbolic batch needs an upper bound for the grid
    check): the attention gate consults it and writes the attention out
    where it is false. The base address is the launch's business
    (:func:`_aligned`)."""
    tensors = (q, k, v)
    if any(t.dim() != 4 for t in tensors):
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in VARIANTS:
        return False
    b, _, h, d = q.shape
    if d not in HEAD_DIMS or b * h > _MAX_GRID_Y:
        return False
    if any(t.stride(3) != 1 for t in tensors):
        return False
    if q.dtype == torch.bfloat16:
        return all(s * t.element_size() % 16 == 0
                   for t in tensors for s in t.stride()[:3])
    return True


def _aligned(t):
    """``t`` itself if its base address is 16-byte aligned, else a
    contiguous copy (the allocator aligns fresh storage), counted in
    ``flash_attention_fwd.realigned``. Only the tensor-core forward calls
    it: an exported program cannot take another branch at run time."""
    if t.data_ptr() % 16 == 0:
        return t
    if not torch.cuda.is_current_stream_capturing():
        flash_attention_fwd.realigned += 1
    return t.clone(memory_format=torch.contiguous_format)


def _device_of(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _launch(name, fn, err_str, device, args):
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(err).decode()} "
                           f"(error {err})")


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _count(wrapper, dtype):
    if torch.cuda.is_current_stream_capturing():
        return  # recorded into a CUDA graph, not launched
    wrapper.launches += 1
    wrapper.variant_launches[VARIANTS[dtype]] += 1


def reset_launch_counts():
    """Zero every kernel wrapper's ``launches`` and ``variant_launches``,
    and the forward's ``realigned`` (inputs copied to an aligned base)."""
    for wrapper in (flash_attention_fwd, flash_attention_bwd_dq,
                    flash_attention_bwd_dkv):
        wrapper.launches = 0  # kernel launches since the last reset
        wrapper.variant_launches = dict.fromkeys(VARIANTS.values(), 0)
    flash_attention_fwd.realigned = 0


def _recorded(name, body, args, kwargs):
    """``body`` as one op of the static Program being recorded, or None
    when none is (``static.program_guard``; nothing inside is recorded)."""
    prog = _dispatch.recorder()
    if prog is None:
        return None
    out = prog._record(body, args, kwargs, name, plain_body=True)
    return None if out is prog.NOT_RECORDED else out


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """q/k/v ``[B, S, H, D]`` -> (O ``[B, S_q, H, D]`` in q's dtype,
    lse ``[B, H, S_q]`` float32). ``scale`` defaults to ``1/sqrt(D)``.
    No autograd: differentiable callers go through :class:`FlashAttention`
    (:func:`flash_attention_bshd`). Calls :data:`flash_attention_fwd_op`."""
    if _dispatch._RECORDING[0]:
        out = _recorded("flash_attention_fwd", flash_attention_fwd,
                        (q, k, v), {"causal": causal, "scale": scale})
        if out is not None:
            return out
    _check(q, k, v, causal)
    _device_of(q)
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        raise RuntimeError(
            "flash_attention_fwd launches the kernel outside autograd; "
            "call flash_attention_bshd (the FlashAttention Function) for "
            "a differentiable result")
    if _dispatch._OBSERVER_LIST is not None:
        return _dispatch.observe_call(
            "flash_attention_fwd", flash_attention_fwd_op, q, k, v,
            bool(causal), _scale(scale, q.shape[3]))
    return flash_attention_fwd_op(q, k, v, bool(causal),
                                  _scale(scale, q.shape[3]))


# The forward as a torch operator. It is defined through ``Library``, not
# the ``custom_op`` decorator, whose Python wrapper adds host time to every
# call, which the eager call of a short kernel pays (PERF.md, section 6).
_LIBRARY = torch.library.Library("paddle_tpu_torch", "DEF")
_LIBRARY.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
                "bool causal, float scale) -> (Tensor, Tensor)")


def _flash_attention_fwd_cpu(q, k, v, causal, scale):
    """The operator on the CPU: the plain version."""
    return flash_attention_fwd_reference(q, k, v, causal, scale)


def _flash_attention_fwd_cuda(q, k, v, causal, scale):
    """The kernel launch: the bf16 (tensor-core) or float32 (CUDA-core)
    forward by dtype; raises on anything neither takes."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if q.dtype == torch.bfloat16:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    variant = _check_cuda({"q": q, "k": k, "v": v}, b, h, d, q.dtype)
    fn, err_str = _kernel("flash_attention_fwd", variant)
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", fn, err_str, q.device,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, s_q, s_k, d,
             *_strides(q, k, v), scale, int(bool(causal))])
    _count(flash_attention_fwd, q.dtype)
    return o, lse


@torch.library.register_fake("paddle_tpu_torch::flash_attention_fwd")
def _flash_attention_fwd_fake(q, k, v, causal, scale):
    """The output shapes, for tracing (``torch.export``'s fake tensors)."""
    b, s_q, h, d = q.shape
    return (q.new_empty((b, s_q, h, d)),
            q.new_empty((b, h, s_q), dtype=torch.float32))


_LIBRARY.impl("flash_attention_fwd", _flash_attention_fwd_cpu, "CPU")
_LIBRARY.impl("flash_attention_fwd", _flash_attention_fwd_cuda, "CUDA")
flash_attention_fwd_op = torch.ops.paddle_tpu_torch.flash_attention_fwd.default


def _check_o(o, q):
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(f"O {tuple(o.shape)} {o.dtype} must have q's "
                         f"shape {tuple(q.shape)}, dtype and device")


def flash_attention_bwd_dq(q, k, v, o, do, lse, causal=False, scale=None):
    """(dQ ``[B, S_q, H, D]`` in q's dtype, delta ``= rowsum(O * dO)``
    float32 ``[B, H, S_q]``) from q/k/v/O/dO ``[B, S, H, D]`` and the
    forward's lse (float32 ``[B, H, S_q]``). The delta is what
    :func:`flash_attention_bwd_dkv` takes."""
    if _dispatch._RECORDING[0]:
        out = _recorded("flash_attention_bwd_dq", flash_attention_bwd_dq,
                        (q, k, v, o, do, lse),
                        {"causal": causal, "scale": scale})
        if out is not None:
            return out
    if _dispatch._OBSERVER_LIST is not None:
        return _dispatch.observe_call(
            "flash_attention_bwd_dq", _flash_attention_bwd_dq, q, k, v, o,
            do, lse, causal, scale)
    return _flash_attention_bwd_dq(q, k, v, o, do, lse, causal, scale)


def _flash_attention_bwd_dq(q, k, v, o, do, lse, causal, scale):
    _check_bwd(q, k, v, do, lse, None, causal)
    _check_o(o, q)
    b, s_q, h, d = q.shape
    scale = _scale(scale, d)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, o, do, lse, causal,
                                                scale)
    tensors = {"q": q, "k": k, "v": v, "O": o, "dO": do}
    variant = _check_cuda(tensors, b, h, d, q.dtype)
    lse = lse.contiguous()
    dq = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    rest = [_DTYPE_CODES[q.dtype], b, h, s_q, k.shape[1], d]
    fn, err_str = _kernel("flash_attention_bwd_dq", variant)
    if variant == "tensor_core":
        delta = torch.empty((b, h, s_q), dtype=torch.float32,
                            device=q.device)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                delta.data_ptr(), *rest, *_strides(q, k, v, o, do)]
    else:
        delta = attention_delta(o, do)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *rest,
                *_strides(q, k, v, do)]
    _launch("flash_attention_bwd_dq", fn, err_str, q.device,
            [*args, scale, int(bool(causal))])
    _count(flash_attention_bwd_dq, q.dtype)
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """(dK, dV), each ``[B, S_k, H, D]`` in the input dtype, from q/k/v/dO,
    the forward's lse and the ``delta`` that :func:`flash_attention_bwd_dq`
    returned (both float32 ``[B, H, S_q]``)."""
    if _dispatch._RECORDING[0]:
        out = _recorded("flash_attention_bwd_dkv", flash_attention_bwd_dkv,
                        (q, k, v, do, lse, delta),
                        {"causal": causal, "scale": scale})
        if out is not None:
            return out
    if _dispatch._OBSERVER_LIST is not None:
        return _dispatch.observe_call(
            "flash_attention_bwd_dkv", _flash_attention_bwd_dkv, q, k, v, do,
            lse, delta, causal, scale)
    return _flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)


def _flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    _check_bwd(q, k, v, do, lse, delta, causal)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = _scale(scale, d)
    if _device_of(q) == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)
    variant = _check_cuda({"q": q, "k": k, "v": v, "dO": do}, b, h, d,
                          q.dtype)
    lse, delta = lse.contiguous(), delta.contiguous()
    fn, err_str = _kernel("flash_attention_bwd_dkv", variant)
    dk = torch.empty((b, s_k, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, s_k, h, d), dtype=v.dtype, device=v.device)
    _launch("flash_attention_bwd_dkv", fn, err_str, q.device,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _DTYPE_CODES[q.dtype], b, h, s_q, s_k, d,
             *_strides(q, k, v, do), scale, int(bool(causal))])
    _count(flash_attention_bwd_dkv, q.dtype)
    return dk, dv


reset_launch_counts()


def attention_delta(o, do):
    """``rowsum(O * dO)`` in float32, ``[B, H, S_q]`` (the reference's
    ``delta``, computed outside its kernels; the bf16 dQ kernel computes
    it itself)."""
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """(dQ, dK, dV) of the attention that gave (O, lse), for the output
    gradient ``do``: the reference's ``_flash_bwd``. The dQ kernel returns
    the delta that the dK/dV kernel takes."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, causal, scale)
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
    differentiable through :class:`FlashAttention` on every device. Under
    ``static.program_guard`` it is one recorded op, whose replay's backward
    is the kernels'."""
    if _dispatch._RECORDING[0]:
        out = _recorded("flash_attention", flash_attention_bshd, (q, k, v),
                        {"causal": causal, "scale": scale})
        if out is not None:
            return out
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


def flash_attention_bwd_dq_reference(q, k, v, o, do, lse, causal, scale):
    """Plain version of the dQ kernel: delta = rowsum(O * dO)
    (:func:`attention_delta`); per 64-row query tile, recompute
    P = exp(S - lse) over the key tiles up to the diagonal and accumulate
    dS.K, dS = P * (dO.V^T - delta); dQ = scale * sum. Returns
    (dQ in q's dtype, delta float32 ``[B, H, S_q]``)."""
    delta = attention_delta(o, do)
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
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous(), delta


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
    _check_bwd(q, k, v, do, lse, None, causal)
    _check_o(o, q)
    scale = _scale(scale, q.shape[3])
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, o, do, lse, causal,
                                                 scale)
    return (dq, *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   causal, scale))
