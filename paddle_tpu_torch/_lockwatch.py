"""Runtime lock-order watchdog: instrumented Lock/RLock/Condition factories
(counterpart: ``paddle_tpu/_lockwatch.py``, the port's own copy; the
environment variable keeps the reference's name).

This module watches the lock orders the PROCESS actually takes. Drop-in factories replace
``threading.Lock/RLock/Condition`` in the thread-heavy runtime modules
(pod coordinator/runtime, the cache prefetch/write-back workers, the
serving batcher, the runlog/flight/metrics writers):

- **Opt-in, near-zero cost when off.** With ``PADDLE_TPU_LOCKWATCH``
  unset the factories return the *raw* ``threading`` primitives — no
  wrapper, no branch on the acquire path, nothing to measure. Armed
  (env ``PADDLE_TPU_LOCKWATCH=1`` before the module constructs its
  locks, or :func:`enable` before constructing a subsystem), each
  factory returns a watched wrapper.
- **Held-set + acquisition-order graph.** Every thread's currently-held
  watched locks form a stack; acquiring B while holding A records the
  edge A->B (by lock *name* — instances created from one site share a
  node) into a process-wide graph. The edge is recorded *before* the
  blocking acquire: the order is hazardous even when this particular
  acquire went through.
- **Online cycle detection.** A new edge that closes a cycle in the
  graph is a POTENTIAL deadlock — two code paths take the same locks in
  opposite orders — even if the process never happened to interleave
  them fatally. The violation is recorded (cycle path + an example
  holder stack per edge + the current thread's stack), counted
  (``lockwatch_order_violations_total``), and dumped through the flight
  recorder (``reason="lock_order_violation"``) when one is armed. The
  watchdog OBSERVES — it never raises into the runtime it watches.
- **Contention accounting.** An acquire that actually blocks adds its
  blocked time to ``lockwatch_contention_ns{lock=...}`` in the shared
  monitor registry, so the metrics board shows where threads queue.
- **Flight-recorder section.** While armed, every flight dump (crash,
  kill-point, ``reason="pod_failure"``) carries a ``lockwatch`` section
  with the edge graph, per-thread held sets, and recorded violations —
  the post-mortem shows who held what at death.

Caveats: name-level graphing skips same-name edges (two instances from
one construction site nesting is usually a hierarchy, not a hazard) and
``enable()`` only affects locks constructed AFTER it — arm via the env
var to cover module-level locks.
"""
import os
import threading
import time
import traceback

__all__ = ["Lock", "RLock", "Condition", "enabled", "enable", "disable",
           "snapshot", "held_names", "violations", "reset", "ENV_VAR"]

ENV_VAR = "PADDLE_TPU_LOCKWATCH"

_enabled = [os.environ.get(ENV_VAR, "").lower() in ("1", "true", "on")]

_graph_mu = threading.Lock()  # raw: guards the edge graph + violations
_adj = {}         # name -> set(successor names)
_edges = {}       # (a, b) -> {"thread", "loc", "stack"} first-observation
_violations = []  # bounded list of violation records
_all_held = {}    # thread ident -> that thread's held list (live view)
_MAX_VIOLATIONS = 64
_STACK_LIMIT = 16

_tls = threading.local()


class _ThreadState:
    __slots__ = ("held", "busy")

    def __init__(self):
        self.held = []    # [ [watched_lock, recursion_count], ... ]
        self.busy = False  # reentrancy guard: inside watch bookkeeping


def _state():
    st = getattr(_tls, "st", None)
    if st is None:
        st = _tls.st = _ThreadState()
        with _graph_mu:
            if len(_all_held) > 256:  # prune dead threads' entries
                live = {t.ident for t in threading.enumerate()}
                for ident in [i for i in _all_held if i not in live]:
                    del _all_held[ident]
            _all_held[threading.get_ident()] = st.held
    return st


def enabled():
    return _enabled[0]


def enable():
    """Arm the factories (locks constructed from here on are watched).
    Returns the prior state. Module-level locks created at import time
    are only watched when the env var was set before import."""
    prev = _enabled[0]
    _enabled[0] = True
    return prev


def disable():
    prev = _enabled[0]
    _enabled[0] = False
    return prev


def reset():
    """Clear the edge graph and recorded violations (tests)."""
    with _graph_mu:
        _adj.clear()
        _edges.clear()
        del _violations[:]


def _caller_name(depth=2):
    try:
        import sys
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "<lock>"


def _escape(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


_stat_add = [None]  # resolved lazily; None until first successful import


def _monitor_add(key, n):
    fn = _stat_add[0]
    if fn is None:
        try:
            from . import monitor
            fn = _stat_add[0] = monitor.stat_add
        except Exception:
            return
    try:
        fn(key, n)
    except Exception:
        pass


def _fmt_stack(limit=_STACK_LIMIT):
    return [f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
            for f in traceback.extract_stack(limit=limit)[:-2]]


def _find_cycle_locked(start, target):
    """Path start -> ... -> target over _adj, or None. Caller holds
    _graph_mu."""
    stack = [(start, [start])]
    seen = {start}
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            if nxt == target:
                return path + [target]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_edge(a, b):
    """Record the order edge a->b; detect a cycle closing. Returns the
    violation record to emit (outside the graph lock), or None."""
    if a == b:
        return None
    adj = _adj.get(a)
    if adj is not None and b in adj:  # fast path: edge already known
        return None
    stack = _fmt_stack()
    with _graph_mu:
        succ = _adj.setdefault(a, set())
        if b in succ:
            return None
        succ.add(b)
        _edges[(a, b)] = {"thread": threading.current_thread().name,
                          "stack": stack}
        back = _find_cycle_locked(b, a)
        if back is None:
            return None
        cycle = [a] + back  # a -> b -> ... -> a
        rec = {
            "edge": [a, b],
            "cycle": cycle,
            "thread": threading.current_thread().name,
            "time": time.time(),
            "stacks": {f"{x}->{y}": dict(_edges.get((x, y)) or {})
                       for x, y in zip(cycle, cycle[1:])},
            "held": [ln for ln in _held_names_unlocked()],
        }
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(rec)
    return rec


def _held_names_unlocked():
    st = getattr(_tls, "st", None)
    if st is None:
        return []
    return [ent[0]._name for ent in st.held]


def _emit_violation(rec):
    """Counter + flight dump for one detected order cycle. Best-effort:
    the watchdog must never take down the runtime it watches."""
    _monitor_add("lockwatch_order_violations_total", 1)
    try:
        from .observability import flight, runlog
        runlog.event("lock_order_violation", cycle=rec["cycle"])
        if flight.installed():
            # flight.dump attaches the lockwatch section itself (the
            # watchdog is necessarily armed when a violation fires)
            flight.dump("lock_order_violation")
    except Exception:
        pass


class _WatchedLock:
    """Instrumented Lock/RLock wrapper: held-set bookkeeping, order-edge
    recording, contention accounting. Duck-types ``threading.Lock`` (and
    the ``_release_save``/``_acquire_restore``/``_is_owned`` protocol
    when the inner lock provides it, so ``threading.Condition`` built on
    a watched RLock waits correctly through the bookkeeping)."""

    def __init__(self, inner, name):
        self._inner = inner
        self._name = name
        self._contention_key = (
            'lockwatch_contention_ns{lock="%s"}' % _escape(name))
        # expose the RLock condition protocol only when the inner lock
        # has it — threading.Condition probes with getattr at __init__,
        # and a plain-Lock inner must raise AttributeError there so the
        # Condition falls back to acquire()/release() (which we watch)
        if hasattr(inner, "_release_save"):
            self._release_save = self._release_save_impl
            self._acquire_restore = self._acquire_restore_impl
            self._is_owned = inner._is_owned

    def _find(self, held):
        for ent in held:
            if ent[0] is self:
                return ent
        return None

    def acquire(self, blocking=True, timeout=-1):
        st = _state()
        if st.busy:  # inside watch bookkeeping: pass straight through
            return self._inner.acquire(blocking, timeout)
        ent = self._find(st.held)
        if ent is not None:  # re-entrant acquire (RLock): no new edge
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                ent[1] += 1
            return ok
        violation = None
        if st.held:
            st.busy = True
            try:
                for h, _n in st.held:
                    v = _note_edge(h._name, self._name)
                    violation = violation or v
            finally:
                st.busy = False
        ok = self._inner.acquire(False)
        if not ok:
            if not blocking:
                if violation is not None:
                    self._safe_emit(st, violation)
                return False
            t0 = time.perf_counter_ns()
            ok = self._inner.acquire(True, timeout)
            dt = time.perf_counter_ns() - t0
            st.busy = True
            try:
                _monitor_add(self._contention_key, dt)
            finally:
                st.busy = False
        if ok:
            st.held.append([self, 1])
        if violation is not None:
            self._safe_emit(st, violation)
        return ok

    @staticmethod
    def _safe_emit(st, violation):
        st.busy = True
        try:
            _emit_violation(violation)
        finally:
            st.busy = False

    def release(self):
        st = _state()
        if st.busy:
            self._inner.release()
            return
        self._inner.release()  # raises first if not held (real semantics)
        ent = self._find(st.held)
        if ent is not None:
            ent[1] -= 1
            if ent[1] <= 0:
                st.held.remove(ent)

    def locked(self):
        inner_locked = getattr(self._inner, "locked", None)
        if inner_locked is not None:
            return inner_locked()
        raise AttributeError("locked")

    # -- threading.Condition protocol (bound per-instance in __init__,
    # only when the inner lock provides it) ---------------------------------
    def _release_save_impl(self):
        st = _state()
        ent = self._find(st.held)
        count = 0
        if ent is not None:
            count = ent[1]
            st.held.remove(ent)
        return (self._inner._release_save(), count)

    def _acquire_restore_impl(self, state):
        inner_state, count = state
        self._inner._acquire_restore(inner_state)
        if count:
            _state().held.append([self, count])

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<WatchedLock {self._name!r} over {self._inner!r}>"


def Lock(name=None):
    """A ``threading.Lock`` — raw when the watchdog is off, watched
    (named ``name``, default the caller's file:line) when armed."""
    if not _enabled[0]:
        return threading.Lock()
    return _WatchedLock(threading.Lock(), name or _caller_name())


def RLock(name=None):
    """A ``threading.RLock`` — raw when off, watched when armed."""
    if not _enabled[0]:
        return threading.RLock()
    return _WatchedLock(threading.RLock(), name or _caller_name())


def Condition(lock=None, name=None):
    """A ``threading.Condition`` — over ``lock`` when given (a watched
    lock keeps its bookkeeping through enter/wait/notify), else over a
    fresh (watched, when armed) RLock."""
    if not _enabled[0]:
        return threading.Condition(lock)
    if lock is None:
        lock = _WatchedLock(threading.RLock(), name or _caller_name())
    return threading.Condition(lock)


def held_names():
    """Names of the watched locks the CURRENT thread holds, outermost
    first (empty when disarmed or none held) — the introspection hook
    regression tests assert lock discipline with."""
    return _held_names_unlocked()


def violations():
    """Recorded order violations (bounded list of dicts)."""
    with _graph_mu:
        return [dict(v) for v in _violations]


def snapshot():
    """JSON-ready view of the watchdog state: the acquisition-order
    edge graph (with first-observation stacks), every thread's current
    held set, and recorded violations. This is the ``lockwatch`` section
    flight dumps carry while armed."""
    names = {t.ident: t.name for t in threading.enumerate()}
    with _graph_mu:
        held = {}
        for ident, lst in _all_held.items():
            entries = [ent[0]._name for ent in list(lst)]
            if entries:
                held[names.get(ident, str(ident))] = entries
        return {
            "enabled": _enabled[0],
            "edges": [{"from": a, "to": b, **meta}
                      for (a, b), meta in sorted(_edges.items())],
            "held": held,
            "violations": [dict(v) for v in _violations],
        }
