"""Activation recompute and host offload (counterpart:
``paddle_tpu/recompute.py``).

A segment's forward runs under ``torch.utils.checkpoint`` (non-reentrant):
the backward reruns it instead of keeping what it computed. The policy says
what the segment keeps all the same::

    none       no segment: the function runs plainly (the A/B control)
    full       nothing; every activation inside is recomputed
    selective  the outputs of matrix products without a batch dimension
               (``aten.mm``/``aten.addmm``: every ``Linear`` and the tied
               decoder); the batched products of the attention and the
               elementwise chains are recomputed (the reference's
               ``dots_with_no_batch_dims_saveable``)
    offload    what ``selective`` keeps, parked in pinned host memory
               until the backward copies it back; on the CPU, where no
               separate host memory exists, it falls back to ``selective``
               with a warning (``strict=True`` raises instead)

Usage::

    from paddle_tpu_torch.recompute import recompute
    out = recompute(block, x, policy="selective")   # immediate
    fn = recompute(block.forward, policy="full")   # wrapper
    layer.enable_recompute("offload")              # the Layer seam

Randomness replays bitwise: the segment's forward keeps what each random
op drew (a dropout's uniform numbers) beside the products its policy keeps,
and the recomputation takes them back instead of drawing again. The
package's generator (``core.random``) thus advances in the forward only, as
without recompute, and a program with recompute draws the same masks as the
same program without it, eagerly and under CUDA-graph capture alike. (A
generator's state cannot be saved under capture: ``graphsafe_get_state``
returns a handle that later draws advance, and ``clone_state`` refuses to
run.) The kept draws cost their bytes until the backward. The segment also
records ``amp.auto_cast``'s state and recomputes under it, since the
backward may run on another thread. torch's ``preserve_rng_state`` is not
used: its host reads break capture.
"""
import collections
import functools
import threading
import warnings
from contextlib import ExitStack, contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .amp.auto_cast import get_amp_state

__all__ = ["recompute", "resolve_policy", "host_offload_available",
           "POLICIES"]

POLICIES = ("none", "full", "selective", "offload")


def nothing_saveable(func):
    return False


def products_without_batch_dims_saveable(func):
    """The 2-D matrix products: what the reference's
    ``dots_with_no_batch_dims_saveable`` keeps."""
    return func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def host_offload_available(device=None):
    """True when a segment on ``device`` (default: the current CUDA device,
    if any) has pinned host memory to park its products in: a CUDA
    device. A CPU tensor has no separate host memory."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def resolve_policy(policy, strict=False, device=None):
    """``(saveable, effective_name)`` for a policy name, ``saveable`` being
    the predicate over aten ops that says which outputs the segment keeps
    (None for ``none``). A callable ``policy`` is taken as that predicate.
    ``offload`` without host memory for ``device`` falls back to
    ``selective`` with a warning, or raises with ``strict=True``."""
    if callable(policy):
        return policy, getattr(policy, "__name__", "custom")
    name = str(policy)
    if name not in POLICIES:
        raise ValueError(f"unknown recompute policy {policy!r}; pick one of "
                         f"{POLICIES} (or pass a predicate over aten ops)")
    if name == "none":
        return None, "none"
    if name == "full":
        return nothing_saveable, "full"
    if name == "selective" or host_offload_available(device):
        return products_without_batch_dims_saveable, name
    msg = ("recompute policy 'offload' needs pinned host memory beside the "
           f"device, and {device if device is not None else 'this process'} "
           "has none")
    if strict:
        raise RuntimeError(msg)
    warnings.warn(msg + "; falling back to 'selective' (the products stay "
                  "in device memory)", stacklevel=3)
    return products_without_batch_dims_saveable, "selective"


# -- pinned host buffers of the offload policy --------------------------------

class _HostPool:
    """Pinned host buffers by (shape, dtype), kept for the process's life:
    a captured step copies into the addresses it was captured with, so a
    buffer is never freed, only handed back. Under capture no buffer can be
    allocated; the eager step before the capture allocates what it needs."""

    def __init__(self):
        self._free = collections.defaultdict(list)
        self._lock = threading.Lock()
        self.allocated = 0

    def take(self, like):
        key = (tuple(like.shape), like.dtype)
        with self._lock:
            if self._free[key]:
                return self._free[key].pop()
        if like.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"no pinned host buffer for an offloaded {key} product "
                "under CUDA-graph capture; run the step once eagerly first")
        buf = torch.empty(key[0], dtype=key[1],
                          pin_memory=like.device.type == "cuda")
        self.allocated += buf.numel() * buf.element_size()
        return buf

    def give(self, buf):
        with self._lock:
            self._free[(tuple(buf.shape), buf.dtype)].append(buf)


_host_pool = _HostPool()


class _Kept:
    """The products a segment's forward kept, in order; offloaded ones are
    (host buffer, device) pairs whose buffers go back to the pool when
    fetched or dropped. As a context around the recomputation, it hands
    back what that did not fetch (it stops once the backward has what it
    needs)."""

    def __init__(self):
        self.items = collections.deque()

    def release(self):
        while self.items:
            item = self.items.popleft()
            if isinstance(item, tuple):
                _host_pool.give(item[0])

    __del__ = release

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def _random_op(func):
    return torch.Tag.nondeterministic_seeded in func.tags


class _KeepProducts(TorchDispatchMode):
    """The forward: keep what every random op drew, and keep (or park on
    the host) the products ``saveable`` picks."""

    def __init__(self, saveable, kept, offload):
        super().__init__()
        self.saveable, self.kept, self.offload = saveable, kept, offload

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _random_op(func):
            # an in-place draw's tensor may be written again later
            self.kept.items.append(out.detach().clone()
                                   if func._schema.is_mutable
                                   else out.detach())
        elif self.saveable(func):
            if self.offload:
                buf = _host_pool.take(out)
                buf.copy_(out, non_blocking=True)
                self.kept.items.append((buf, out.device))
            else:
                self.kept.items.append(out.detach())
        return out


class _ReuseProducts(TorchDispatchMode):
    """The recomputation: what the forward kept replaces the op."""

    def __init__(self, saveable, kept):
        super().__init__()
        self.saveable, self.kept = saveable, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _random_op(func):
            drawn = self.kept.items.popleft()
            if func._schema.is_mutable:
                return args[0].copy_(drawn)
            return drawn
        if self.saveable(func):
            item = self.kept.items.popleft()
            if not isinstance(item, tuple):
                return item
            buf, device = item
            out = torch.empty(buf.shape, dtype=buf.dtype, device=device)
            out.copy_(buf, non_blocking=True)
            _host_pool.give(buf)
            return out
        return func(*args, **(kwargs or {}))


@contextmanager
def _amp_state(state):
    """Run the block under ``auto_cast``'s state ``state``."""
    amp = get_amp_state()
    saved = (amp.enabled, amp.dtype, amp.level, amp.custom_white,
             amp.custom_black)
    (amp.enabled, amp.dtype, amp.level, amp.custom_white,
     amp.custom_black) = state
    try:
        yield
    finally:
        (amp.enabled, amp.dtype, amp.level, amp.custom_white,
         amp.custom_black) = saved


# -- the segment --------------------------------------------------------------

def _device_of(args, kwargs):
    for x in list(args) + list(kwargs.values()):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


@contextmanager
def _stack(*contexts):
    with ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _segment_call(fn, args, kwargs, policy):
    """``fn(*args, **kwargs)`` as one recompute segment; under
    ``static.program_guard``, one recorded op (``recompute``) whose replay
    is the segment: nothing inside it is recorded."""
    from .core import dispatch
    prog = dispatch.recorder()
    if prog is not None:
        out = prog._record(_replayable(fn, policy, args, kwargs), args,
                           kwargs, "recompute", plain_body=True)
        if out is not prog.NOT_RECORDED:
            return out
    return _segment_now(fn, args, kwargs, policy)


def _replayable(fn, policy, args, kwargs):
    """The segment over plain tensors (a recorded op's form); a segment
    written over the package's ``Tensor`` gets ``Tensor``s."""
    from .core.tensor import Tensor, unwrap, wrap
    wrapped = any(type(a) is Tensor for a in list(args) + list(
        kwargs.values()))

    def segment(*a, **k):
        if wrapped:
            return unwrap(_segment_now(fn, wrap(a), wrap(k), policy))
        return _segment_now(fn, a, k, policy)
    segment.__name__ = "recompute"
    return segment


def _segment_now(fn, args, kwargs, policy):
    device = _device_of(args, kwargs)
    saveable, name = resolve_policy(policy, device=device)
    if saveable is None:
        return fn(*args, **kwargs)
    amp = get_amp_state()
    state = (amp.enabled, amp.dtype, amp.level, set(amp.custom_white),
             set(amp.custom_black))
    kept = _Kept()

    def contexts():
        return (_KeepProducts(saveable, kept, name == "offload"),
                _stack(_amp_state(state), _ReuseProducts(saveable, kept),
                       kept))

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=contexts, **kwargs)


def remat_replay(fn):
    """Mark ``fn`` as a rematerialization's replay of a segment's forward
    (the reference's static-graph marker, which its graph verifier reads;
    the port's recompute segments replay through ``torch.utils.checkpoint``
    and read no marker)."""
    fn._remat_replay = True
    return fn


def is_remat_replay(fn):
    return bool(getattr(fn, "_remat_replay", False))


def recompute(function, *args, policy="full", **kwargs):
    """Run (or wrap) ``function`` as an activation-recompute segment.

    With call arguments it runs now::

        y = recompute(block, x, policy="selective")

    Without them it returns the wrapped callable::

        block_fn = recompute(block.forward, policy="offload")

    ``policy`` is one of :data:`POLICIES` or a predicate over aten ops
    saying which outputs to keep. Segments are forward-only: no
    ``backward()`` or optimizer step inside."""
    if not callable(function):
        raise TypeError(f"recompute expects a callable, got {function!r}")
    if not callable(policy):
        resolve_policy(policy, device="cuda")  # validate the name now
    if not args and not kwargs:
        @functools.wraps(function)
        def wrapped(*a, **k):
            return _segment_call(function, a, k, policy)
        wrapped._recompute_policy = policy
        return wrapped
    return _segment_call(function, args, kwargs, policy)
