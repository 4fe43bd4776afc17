"""The op-observer seam (counterpart: ``paddle_tpu/core/dispatch.py``).

In the reference every Tensor op runs through ``call_op``, which calls the
registered observers (the profiler's per-op events, the
``FLAGS_check_nan_inf`` checker, the sampled dispatch telemetry) around
it. The port keeps the models' insides on plain tensors, so the seam is
rebuilt over torch's own hook, a ``TorchFunctionMode``:

- Each observer has ``begin(name) -> token`` and ``end(token, name,
  outputs)``. They are kept in one process-wide dict; ``_OBSERVER_LIST``
  is its flat view, ``None`` when empty, so an unobserved caller pays one
  global read.
- An observer with a ``period`` sees one op in ``period`` (the sampled
  dispatch telemetry): the seam counts the ops since the last
  registration and calls it on every ``period``-th, as the reference's
  sampler counts its own calls. When every registered observer samples
  by one period, the mode's handler calls every other op straight after
  that count, without entering the observers.
- While an observer is registered, every Python thread carries the mode
  :class:`_ObserverMode` (torch keeps its mode stacks per thread): the
  registering thread pushes it at once, every other thread at its next
  Python call, through a one-shot profile hook
  (``threading.setprofile_all_threads``). Removing the last observer pops
  it on the removing thread and clears every hook still pending (a
  pending profile hook keeps CPython's call instrumentation on for every
  thread); another thread that took the mode keeps it, passing every call
  through, until it calls :func:`sync_thread` (the serving worker does,
  before each batch). With no observer, no mode is pushed on the thread
  that runs an eager step: the same code path as without the seam.
- Names: the port's ``ops`` library and functionals report under the
  reference's ``op_display_name`` of the same public function
  (:func:`call_op`, reached through ``core.tensor.boundary``); the three
  flash kernels under the reference's kernel names
  (:func:`observe_call`); every other torch call under torch's own name
  (``linear``, ``layer_norm``, ``__add__``, ...). Inside an observed op
  nothing else is observed, so an op is one event.
- Like the reference's static trace (``_STATIC_HOOK``), a CUDA-graph
  capture runs no observer (:func:`static_scope`, and any capturing
  stream): a host read inside ``torch.cuda.graph`` breaks the capture,
  and a replayed graph runs no Python, so it is observed by no one.
"""
import sys
import threading

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["call_op", "call_op_nograd", "wrap", "unwrap", "add_observer",
           "remove_observer", "op_display_name", "observe_call",
           "static_scope", "sync_thread"]


def op_display_name(fn, op_name=None):
    """Canonical op name: the one naming scheme shared by the sampled
    dispatch telemetry, the profiler and the NaN checker."""
    return op_name or getattr(fn, "__name__", None) or "op"


_OBSERVERS = {}
_OBSERVER_LIST = None
_PAIRS = ()     # (observer, its period) of each registered observer
_GATE = None    # the one period, when every observer samples by it
_TICK = [0]     # ops seen since the last registration
_lock = threading.Lock()
_STATIC_DEPTH = [0]  # > 0 while a CUDA graph is being captured


class _ThreadState(threading.local):
    def __init__(self):
        self.busy = False   # inside an observed op or an observer
        self.mode = None    # the _ObserverMode this thread has pushed


_tls = _ThreadState()

# torch calls that read metadata and compute nothing, and the autograd
# entry points (the backward's own ops, the kernels' among them, report
# themselves): not ops
_NOT_OPS = frozenset({
    "backward", "grad",
    "__get__", "__set__", "__delete__", "dim", "size", "stride",
    "data_ptr", "is_contiguous", "numel", "element_size", "nelement",
    "storage_offset", "untyped_storage", "is_floating_point",
    "is_complex", "__len__", "__repr__", "__format__", "__hash__",
    "__bool__", "__index__", "__int__", "__float__", "item", "tolist",
    "get_device", "requires_grad_", "retain_grad", "register_hook",
    "_is_view", "is_set_to", "__reduce_ex__", "__setstate__",
    "__deepcopy__", "numpy", "__array__", "__dlpack__"})


def _publish():
    """Refresh the registry's flat views (under ``_lock``)."""
    global _OBSERVER_LIST, _PAIRS, _GATE
    periods = [getattr(o, "period", None) for o in _OBSERVERS.values()]
    _GATE = periods[0] if len(set(periods)) == 1 else None
    _PAIRS = tuple((o, n or 1) for o, n in zip(_OBSERVERS.values(), periods))
    _OBSERVER_LIST = list(_OBSERVERS.values()) or None


def add_observer(key, obs):
    with _lock:
        _OBSERVERS[key] = obs
        first = _OBSERVER_LIST is None
        _TICK[0] = 0
        _publish()
        if first:
            _enter_mode()
            threading.setprofile_all_threads(_push_hook)


def remove_observer(key):
    with _lock:
        removed = _OBSERVERS.pop(key, None) is not None
        _publish()
        if removed and not _OBSERVERS:
            _exit_mode()
            threading.setprofile_all_threads(None)


def _push_hook(frame, event, arg):
    """One-shot profile hook: this thread takes the mode, then stops
    profiling."""
    sys.setprofile(None)
    if _OBSERVER_LIST is not None:
        _enter_mode()


def sync_thread():
    """Bring this thread's mode in line with the registry: push it while
    an observer is registered, pop it when none is (a long-lived worker
    calls this between units of work)."""
    if _OBSERVER_LIST is not None:
        if _tls.mode is None:
            _enter_mode()
    elif _tls.mode is not None:
        _exit_mode()


def _enter_mode():
    if _tls.mode is None:
        mode = _ObserverMode()
        mode.__enter__()
        _tls.mode = mode


def _exit_mode():
    """Pop this thread's mode when it is the innermost one (a mode pushed
    after it stays, and ours then passes every call through)."""
    mode = _tls.mode
    if mode is None:
        return
    stack = torch.overrides._get_current_function_mode_stack()
    if stack and stack[-1] is mode:
        mode.__exit__(None, None, None)
        _tls.mode = None


def _suspended():
    return _STATIC_DEPTH[0] > 0 or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def _observed(name, run, ticked=False):
    """Run ``run()`` under the registered observers, as op ``name``
    (``ticked``: the caller has counted the op already)."""
    obs = _OBSERVER_LIST
    if obs is None or _tls.busy or _suspended():
        return run()
    if not ticked:
        _TICK[0] += 1
    tick = _TICK[0]
    obs = [o for o, n in _PAIRS if tick % n == 0]
    _tls.busy = True  # an op is one op, sampled or not: nothing inside
    try:
        if not obs:
            return run()
        pairs = [(o, o.begin(name)) for o in obs]
        out = run()
        flat = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        for o, tok in pairs:
            o.end(tok, name, flat)
    finally:
        _tls.busy = False
    return out


class _ObserverMode(TorchFunctionMode):
    """Every torch call of this thread through the observers, under
    torch's name for it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _OBSERVER_LIST is None or _tls.busy:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", None) or str(func)
        if name in _NOT_OPS:
            return func(*args, **kwargs)
        gate = _GATE
        if gate is not None:
            _TICK[0] += 1
            if _TICK[0] % gate:
                return func(*args, **kwargs)  # not a sampled op
            return _observed(name, lambda: func(*args, **kwargs), True)
        return _observed(name, lambda: func(*args, **kwargs))


def observe_call(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` reported as the one op ``name`` (the kernel
    wrappers' launch report; its caller checks ``_OBSERVER_LIST`` first)."""
    return _observed(name, lambda: fn(*args, **kwargs))


class static_scope:
    """No observer runs inside: a CUDA-graph capture (the reference's
    static trace)."""

    def __enter__(self):
        _STATIC_DEPTH[0] += 1
        return self

    def __exit__(self, *exc):
        _STATIC_DEPTH[0] -= 1
        return False


def unwrap(x):
    """A ``Tensor``'s plain torch tensor (anything else as is)."""
    from .tensor import unwrap as _unwrap
    return _unwrap(x)


def wrap(value):
    """Tensor results of an op as ``Tensor``s (anything else as is)."""
    from .tensor import wrap as _wrap
    return _wrap(value)


def call_op(fn, *args, op_name=None, **kwargs):
    """``fn`` on the plain tensors of ``args``, under the observers as op
    ``op_display_name(fn, op_name)``; tensor results come back as
    ``Tensor``s. Autograd records as torch records ``fn``'s own ops."""
    name = op_display_name(fn, op_name)
    a = [unwrap(x) for x in args]
    k = {key: unwrap(v) for key, v in kwargs.items()}
    return wrap(_observed(name, lambda: fn(*a, **k)))


def call_op_nograd(fn, *args, op_name=None, **kwargs):
    """:func:`call_op` without recording a gradient."""
    with torch.no_grad():
        return call_op(fn, *args, op_name=op_name, **kwargs)


# -- static-program recording (``static.program_guard``) ---------------------

class _RecordState(threading.local):
    def __init__(self):
        self.program = None  # the Program this thread records into
        self.stack = []      # it and the Programs it is recorded within
        self.busy = False    # inside an op being recorded, or a replay


_rec = _RecordState()
_RECORDING = [0]  # program guards open on any thread


def recorder():
    """The Program this thread records into, or None: no guard is open,
    or the caller runs inside an op that is being recorded or replayed
    (nothing inside a recorded op is recorded)."""
    if not _RECORDING[0] or _rec.busy:
        return None
    return _rec.program


class suspend_recording:
    """Nothing inside is recorded into a Program (an op's own body, a
    replay); ``suspend_recording(False)`` records again inside (a
    control-flow block recorded within its construct's op)."""

    def __init__(self, busy=True):
        self._busy = busy

    def __enter__(self):
        self._saved = _rec.busy
        _rec.busy = self._busy
        return self

    def __exit__(self, *exc):
        _rec.busy = self._saved
        return False
