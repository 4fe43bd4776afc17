"""Span tracing and guarded counters (counterpart:
``paddle_tpu/observability/tracing.py``).

- ``trace_span(name, cat, **attrs)``: a context-managed span on a
  thread-local stack. Disabled (the default), it returns a shared no-op
  span: no allocation, one list read and one set lookup.
- Trace context: every recorded span carries ``(trace_id, span_id,
  parent_id)``; nested spans inherit the trace and the parent, a root span
  mints a new trace. ``trace_context()``, ``attach_context(trace,
  parent)`` and ``mint_context()`` carry it across threads and processes.
- ``count(name, value)``: a counter of ``monitor``, guarded by the switch.
- ``enable(categories=[...], dispatch_sample_rate=0.01)`` turns on a
  subset of ``CATEGORIES``. ``dispatch`` (off by default) registers the
  sampled op observer at ``core.dispatch``: per-op ``op/<name>`` spans
  and the ``dispatch_op_sampled{op=}`` / ``dispatch_op_ns{op=}``
  counters.
- Compile events: the reference mirrors jax's compile events; the port's
  are its own. The nvcc build of a kernel library at first use
  (``kernels/_build.py``) adds to ``jit_backend_compile_ns`` and
  ``jit_backend_compiles``, and a CUDA-graph capture (a ``to_static`` unit
  or a serving bucket) to ``jit_compile_ns``, as a ``jit`` span
  (:func:`record_compile`). ``StepTimer``'s compile-stall fraction reads
  them.

A completed span goes to three sinks: the profiler's event buffer (the
one buffer; :func:`spans` and :func:`reset` read and clear it), the
flight recorder's ring (``flight.py``) and, when a run-log is active, its
JSONL stream (``runlog.py``).
"""
import random
import threading

from .. import monitor, profiler
from . import flight, runlog

__all__ = ["enable", "disable", "enabled", "trace_span", "current_span",
           "count", "now_ns", "CATEGORIES", "DEFAULT_CATEGORIES",
           "trace_context", "attach_context", "mint_context",
           "record_span", "spans", "reset", "Span", "record_compile"]

# every instrumented subsystem; "dispatch" is opt-in (sampled per-op spans)
CATEGORIES = ("executor", "jit", "dataloader", "collective", "ps",
              "dispatch", "step", "serving", "checkpoint", "user")
DEFAULT_CATEGORIES = frozenset(c for c in CATEGORIES if c != "dispatch")

_enabled_cats = [None]  # None = disabled; frozenset of categories otherwise


class _SpanStack(threading.local):
    def __init__(self):
        self.stack = []
        self.remote = None  # (trace_id, parent_span_id) adopted via
        # attach_context — the cross-process/thread parent for root spans
        # opened on this thread
        self.rng = None


_tls = _SpanStack()


def _new_id():
    """64-bit span/trace id. Per-thread RNG (random.Random instances are
    not thread-safe) seeded from SystemRandom so concurrent processes
    and restarts never collide."""
    rng = _tls.rng
    if rng is None:
        rng = _tls.rng = random.Random(
            random.SystemRandom().getrandbits(64))
    return rng.getrandbits(64) or 1  # 0 is the "no id" sentinel


def now_ns():
    """The span clock: the profiler's (monotonic nanoseconds)."""
    return profiler._now_ns()


def trace_context():
    """The current (trace_id, span_id) pair on this thread — what a
    client piggybacks on an outgoing RPC — or None outside any span
    (an adopted remote context counts: it returns (trace, parent))."""
    stack = _tls.stack
    if stack:
        s = stack[-1]
        return (s.trace_id, s.span_id)
    return _tls.remote


def mint_context():
    """Reserve ids for a span recorded retrospectively (a serving
    request whose duration is only known at resolve time). Returns
    ``(trace_id, span_id, parent_id)``: a child of the current span
    when one is active, else a new root trace."""
    ctx = trace_context()
    if ctx is not None:
        return (ctx[0], _new_id(), ctx[1])
    return (_new_id(), _new_id(), 0)


class attach_context:
    """Adopt a remote parent on this thread: spans opened inside become
    children of ``(trace_id, parent_id)`` instead of starting new
    traces — the receive side of wire propagation.

    >>> with tracing.attach_context(*request_ctx[:2]):
    ...     with trace_span("serve", cat="serving"): ...
    """

    def __init__(self, trace_id, parent_id):
        self._ctx = (int(trace_id), int(parent_id))
        self._saved = None

    def __enter__(self):
        self._saved = _tls.remote
        _tls.remote = self._ctx
        return self

    def __exit__(self, *exc):
        _tls.remote = self._saved
        return False


def enabled(cat=None):
    """Fast guard: is tracing on (for `cat`)? Instrumented paths call this
    before doing any measurement work."""
    cats = _enabled_cats[0]
    if cats is None:
        return False
    return True if cat is None else cat in cats


def spans():
    """The completed spans recorded since the last :func:`reset`, as dicts
    (``name``, ``cat``, ``t0``, ``t1``, ``trace_id``, ``span_id``,
    ``parent_id``, ``attrs``): read from the profiler's buffer."""
    return profiler.spans()


def reset():
    """Drop the recorded spans (the profiler's buffer)."""
    profiler.reset()


def _emit(name, cat, t0, t1, trace_id, span_id, parent_id, attrs):
    """One completed span to every sink: the profiler buffer (chrome
    trace), the flight ring (crash evidence) and the active run-log."""
    profiler.record_span(name, cat, t0, t1,
                         span=(trace_id, span_id, parent_id, attrs or {}))
    flight.record(name, cat, t0, t1, trace_id, span_id, parent_id, attrs)
    if runlog.active() is not None:
        runlog.span(name, cat, t0, t1, trace_id, span_id, parent_id,
                    attrs)


def record_span(name, cat, t0_ns, t1_ns, trace_id=None, span_id=None,
                parent_id=None, **attrs):
    """Record a completed span retrospectively (queue-wait measured
    after the fact, a request span closed at resolve time). Missing ids
    are minted from the current thread context; pass explicit ids (from
    :func:`mint_context`) to place the span in a remote trace. Returns
    ``(trace_id, span_id)`` — no-op (returns None) when tracing or the
    category is off."""
    cats = _enabled_cats[0]
    if cats is None or cat not in cats:
        return None
    if trace_id is None:
        trace_id, span_id, parent_id = mint_context()
    elif span_id is None:
        span_id = _new_id()
    _emit(name, cat, int(t0_ns), int(t1_ns), int(trace_id), int(span_id),
          int(parent_id or 0), attrs or None)
    return (trace_id, span_id)


class Span:
    """Active span; records into the span buffer (and the run-log) on
    exit. Nesting is tracked on a thread-local
    stack (``current_span()``); the trace context (trace_id, span_id,
    parent_id) is inherited from the enclosing span, an attached remote
    context, or minted fresh for a root span."""

    __slots__ = ("name", "cat", "attrs", "_t0",
                 "trace_id", "span_id", "parent_id")

    def __init__(self, name, cat, attrs):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._t0 = None
        self.trace_id = 0
        self.span_id = 0
        self.parent_id = 0

    def set_attr(self, **kwargs):
        self.attrs.update(kwargs)
        return self

    @property
    def context(self):
        """(trace_id, span_id) — piggyback this on outgoing work."""
        return (self.trace_id, self.span_id)

    def __enter__(self):
        stack = _tls.stack
        if stack:
            top = stack[-1]
            self.trace_id, self.parent_id = top.trace_id, top.span_id
        elif _tls.remote is not None:
            self.trace_id, self.parent_id = _tls.remote
        else:
            self.trace_id, self.parent_id = _new_id(), 0
        self.span_id = _new_id()
        stack.append(self)
        self._t0 = profiler._now_ns()
        return self

    def __exit__(self, *exc):
        end = profiler._now_ns()
        stack = _tls.stack
        if stack and stack[-1] is self:
            stack.pop()
        _emit(self.name, self.cat, self._t0, end, self.trace_id,
              self.span_id, self.parent_id, self.attrs or None)
        return False


class _NullSpan:
    """Shared disabled span — no state, no allocation per use."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, **kwargs):
        return self


NULL_SPAN = _NullSpan()


def trace_span(name, cat="user", **attrs):
    """Open a span: ``with trace_span("executor/run", cat="executor"): ...``.
    Returns the shared no-op span when tracing (or `cat`) is disabled."""
    cats = _enabled_cats[0]
    if cats is None or cat not in cats:
        return NULL_SPAN
    return Span(name, cat, attrs)


def current_span():
    """Innermost active span on this thread, or None."""
    stack = _tls.stack
    return stack[-1] if stack else None


def count(name, value=1, cat=None):
    """Guarded counter add into the shared monitor registry."""
    cats = _enabled_cats[0]
    if cats is None or (cat is not None and cat not in cats):
        return
    monitor.stat_add(name, value)


def record_compile(kind, t0_ns, t1_ns, **attrs):
    """A compile event of the port: ``kind`` ``"backend"`` (an nvcc
    build) adds to ``jit_backend_compile_ns`` and ``jit_backend_compiles``;
    ``"capture"`` (a CUDA-graph capture) to ``jit_compile_ns``. Either is
    also a ``jit`` span. Guarded by the ``jit`` category, as the
    reference's compile hook is."""
    if not enabled("jit"):
        return
    dur = int(t1_ns) - int(t0_ns)
    if kind == "backend":
        monitor.stat_add("jit_backend_compile_ns", dur)
        monitor.stat_add("jit_backend_compiles", 1)
        name = "jit/backend_compile"
    elif kind == "capture":
        monitor.stat_add("jit_compile_ns", dur)
        monitor.stat_add("jit_compiles", 1)
        name = "jit/capture"
    else:
        raise ValueError(f"unknown compile kind {kind!r}")
    record_span(name, "jit", t0_ns, t1_ns, **attrs)


# -- sampled op-dispatch observer -----------------------------------------

_op_label_re = None


def _op_label(name):
    """Sanitize an op name into a Prometheus label value (op names come
    from ``dispatch.op_display_name``)."""
    global _op_label_re
    if _op_label_re is None:
        import re
        _op_label_re = re.compile(r'[^0-9A-Za-z_./:-]')
    return _op_label_re.sub("_", name)


class _SampledOpObserver:
    """Per-op spans through the ``core.dispatch`` seam, sampled by period
    so the op path stays cheap: the seam calls it on one op in
    ``period`` (it counts the ops), and each call is one span."""

    def __init__(self, sample_rate=0.01):
        self.period = max(1, int(round(1.0 / max(sample_rate, 1e-9))))

    def begin(self, name):
        return profiler._now_ns()

    def end(self, token, name, outputs):
        end_ns = profiler._now_ns()
        profiler.record_span(f"op/{name}", "dispatch", token, end_ns)
        monitor.stat_add("dispatch_sampled_ops", 1)
        from .export import format_labels
        key = format_labels("dispatch_op", op=_op_label(name))
        monitor.stat_add("dispatch_op_sampled" + key, 1)
        monitor.stat_add("dispatch_op_ns" + key, end_ns - token)


def enable(categories=None, dispatch_sample_rate=0.01):
    """Turn on tracing for ``categories`` (default: every category but
    ``dispatch``) and the profiler's event collection, so spans reach the
    chrome trace. Starts the run-log named by ``PADDLE_TPU_RUNLOG_DIR``
    and arms the flight recorder at ``PADDLE_TPU_FLIGHT_DIR`` when they
    are set. With ``dispatch``, registers the sampled op observer at
    ``dispatch_sample_rate``."""
    cats = (frozenset(categories) if categories is not None
            else DEFAULT_CATEGORIES)
    unknown = cats - frozenset(CATEGORIES)
    if unknown:
        raise ValueError(
            f"unknown trace categories {sorted(unknown)}; "
            f"valid: {list(CATEGORIES)}")
    _enabled_cats[0] = cats
    profiler.enable_collection()
    runlog.maybe_start_from_env()
    flight.maybe_install_from_env()
    from ..core import dispatch
    if "dispatch" in cats:
        dispatch.add_observer("observability",
                              _SampledOpObserver(dispatch_sample_rate))
    else:
        # an enable without "dispatch" tears a previous sampler down
        dispatch.remove_observer("observability")


def disable():
    """Turn tracing off and stop the profiler's event collection.
    Recorded spans stay until :func:`reset`."""
    _enabled_cats[0] = None
    from ..core import dispatch
    dispatch.remove_observer("observability")
    profiler.disable_collection()
