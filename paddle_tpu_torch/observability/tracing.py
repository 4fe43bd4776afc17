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
- ``enable(categories=[...])`` turns on a subset of ``CATEGORIES``.

A completed span goes to the in-process span buffer (:func:`spans`,
:func:`reset`) and, when a run-log is active, to its JSONL stream
(``runlog.py``). Not ported: the JAX compile hook and the sampled
op-dispatch observer (the ``dispatch`` category records nothing here).
"""
import random
import threading
import time

from .. import monitor
from . import runlog

__all__ = ["enable", "disable", "enabled", "trace_span", "current_span",
           "count", "now_ns", "CATEGORIES", "DEFAULT_CATEGORIES",
           "trace_context", "attach_context", "mint_context",
           "record_span", "spans", "reset", "Span"]

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
    """The span clock: monotonic nanoseconds."""
    return time.monotonic_ns()


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


_spans = []  # completed spans, in the order they ended
_spans_lock = threading.Lock()


def spans():
    """The completed spans recorded since the last :func:`reset`, as dicts
    (``name``, ``cat``, ``t0``, ``t1``, ``trace_id``, ``span_id``,
    ``parent_id``, ``attrs``)."""
    with _spans_lock:
        return list(_spans)


def reset():
    """Drop the recorded spans."""
    with _spans_lock:
        _spans.clear()


def _emit(name, cat, t0, t1, trace_id, span_id, parent_id, attrs):
    """One completed span to the span buffer and the active run-log."""
    with _spans_lock:
        _spans.append({"name": name, "cat": cat, "t0": t0, "t1": t1,
                       "trace_id": trace_id, "span_id": span_id,
                       "parent_id": parent_id, "attrs": attrs or {}})
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
        self._t0 = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
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


def enable(categories=None):
    """Turn on tracing for ``categories`` (default: every category but
    ``dispatch``). Starts the run-log named by ``PADDLE_TPU_RUNLOG_DIR``
    when one is set and none is active."""
    cats = (frozenset(categories) if categories is not None
            else DEFAULT_CATEGORIES)
    unknown = cats - frozenset(CATEGORIES)
    if unknown:
        raise ValueError(
            f"unknown trace categories {sorted(unknown)}; "
            f"valid: {list(CATEGORIES)}")
    _enabled_cats[0] = cats
    runlog.maybe_start_from_env()


def disable():
    """Turn tracing off. Recorded spans stay until :func:`reset`."""
    _enabled_cats[0] = None
