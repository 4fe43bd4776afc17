"""Deterministic fault injection: named kill points (counterpart:
``paddle_tpu/testing/faults.py``).

Code calls :func:`kill_point` at stages where a failure matters (each
stage of a checkpoint write). Unarmed, a kill point only counts its hits.
A test arms one with :func:`inject`: the next ``times`` hits (after
``skip`` free passes) raise the injected exception and/or sleep an
injected latency, with no randomness anywhere, so a chaos test replays
alike every time.

Instrumented points: ``checkpoint/*``, every stage of the crash-consistent
checkpoint write (``paddle_tpu_torch.checkpoint.core.KILL_POINTS``), and
``checkpoint/pod_*``, the multi-process checkpoint's
(``checkpoint.multihost.POD_KILL_POINTS`` and the read side's
``checkpoint/pod_restore``).

**Process-level kill points**: arming a point with
:func:`arm_process_kill`, or through the ``PADDLE_TPU_PROCESS_KILL``
environment variable, ``"<point>@<rank>[#<nth>]"`` (comma-separated;
``rank`` matches this process's ``PADDLE_TRAINER_ID``), makes the process
**SIGKILL itself** at the nth hit of that point: no handler runs, as in a
preemption or an out-of-memory kill. The only evidence left is a
``process_kill`` run-log event flushed just before the signal.
"""
import os
import signal
import threading
import time

__all__ = ["FaultInjected", "inject", "clear", "kill_point", "hits",
           "fired", "armed", "reset", "scoped", "snapshot",
           "arm_process_kill", "process_kills"]


class FaultInjected(Exception):
    """Default exception raised by an armed kill-point."""

    def __init__(self, point):
        self.point = point
        super().__init__(f"injected fault at kill-point {point!r}")


class _Fault:
    __slots__ = ("exc", "times", "skip", "latency_s")

    def __init__(self, exc, times, skip, latency_s):
        self.exc = exc
        self.times = times
        self.skip = skip
        self.latency_s = latency_s


_lock = threading.RLock()
_armed = {}   # point -> _Fault
_hits = {}    # point -> kill_point passes (armed or not)
_fired = {}   # point -> injections actually raised/slept
_proc_kills = None  # point -> nth hit that SIGKILLs THIS process
                    # (None = env not parsed yet; {} = none armed)


def _load_process_kills():
    """Parse ``PADDLE_TPU_PROCESS_KILL`` ("<point>@<rank>[#<nth>]",
    comma-separated) keeping only specs whose rank matches this
    process's ``PADDLE_TRAINER_ID``. Parsed once; :func:`reset`
    re-reads (tests adjusting the env must reset)."""
    global _proc_kills
    out = {}
    my_rank = os.environ.get("PADDLE_TRAINER_ID")
    for part in os.environ.get("PADDLE_TPU_PROCESS_KILL", "").split(","):
        part = part.strip()
        if not part or "@" not in part:
            continue
        point, _, rest = part.partition("@")
        rank_s, _, nth_s = rest.partition("#")
        try:
            nth = int(nth_s) if nth_s else 1
        except ValueError:
            continue
        if my_rank is not None and rank_s.strip() == my_rank:
            out[point.strip()] = max(1, nth)
    _proc_kills = out
    return out


def arm_process_kill(point, nth=1):
    """Arm a process-level kill: the ``nth`` hit of ``point`` SIGKILLs
    THIS process (no unwind, no handler — a real rank death)."""
    global _proc_kills
    with _lock:
        kills = _proc_kills if _proc_kills is not None \
            else _load_process_kills()
        kills[point] = max(1, int(nth))
        _proc_kills = kills
    return point


def process_kills():
    """The armed process-kill table for this process (parses the env on
    first use)."""
    with _lock:
        kills = _proc_kills if _proc_kills is not None \
            else _load_process_kills()
        return dict(kills)


def _suicide(point):
    """Leave a flushed run-log event, then SIGKILL this process. SIGKILL
    cannot be caught or blocked: nothing else runs, as in a real rank
    death."""
    try:
        from ..observability import runlog
        runlog.event("process_kill", point=point, pid=os.getpid(),
                     rank=os.environ.get("PADDLE_TRAINER_ID"),
                     signal="SIGKILL")
    except Exception:
        pass
    os.kill(os.getpid(), signal.SIGKILL)


def inject(point, exc=FaultInjected, times=1, skip=0, latency_s=0.0):
    """Arm ``point``: after ``skip`` free passes, the next ``times`` hits
    sleep ``latency_s`` (if non-zero) and raise ``exc`` (an exception
    class — instantiated with the point name when it accepts one arg —
    or a ready instance; ``exc=None`` injects latency only)."""
    with _lock:
        _armed[point] = _Fault(exc, int(times), int(skip), float(latency_s))
    return point


def clear(point=None):
    """Disarm one kill-point, or all of them (``point=None``)."""
    with _lock:
        if point is None:
            _armed.clear()
        else:
            _armed.pop(point, None)


def reset():
    """Disarm everything (process kills re-read the env on next use)
    and zero the hit/fired counters."""
    global _proc_kills
    with _lock:
        _armed.clear()
        _hits.clear()
        _fired.clear()
        _proc_kills = None


def hits(point):
    with _lock:
        return _hits.get(point, 0)


def fired(point):
    with _lock:
        return _fired.get(point, 0)


def armed(point):
    with _lock:
        return point in _armed


def snapshot():
    """JSON-ready view of the harness state: armed points with their
    remaining budget, plus the lifetime hit/fired counters."""
    with _lock:
        return {
            "armed": {p: {"times": f.times, "skip": f.skip,
                          "latency_s": f.latency_s,
                          "exc": (f.exc if f.exc is None
                                  else getattr(f.exc, "__name__",
                                               repr(f.exc)))}
                      for p, f in _armed.items()},
            "hits": dict(_hits),
            "fired": dict(_fired),
            "process_kills": dict(_proc_kills or {}),
        }


def _make_exc(exc, point):
    if exc is None:
        return None
    if isinstance(exc, BaseException):
        return exc
    try:
        return exc(point)
    except TypeError:
        return exc()


def kill_point(point):
    """Mark a failure-prone stage. No-op (one dict increment) unless a
    test armed this point with :func:`inject` or a process-level kill
    is armed for this rank."""
    kills = _proc_kills if _proc_kills is not None else _load_process_kills()
    if not _armed and not kills:
        # nothing armed anywhere in the process: count the pass without
        # the lock (a diagnostic counter; armed points count exactly)
        _hits[point] = _hits.get(point, 0) + 1
        return
    with _lock:
        _hits[point] = _hits.get(point, 0) + 1
        n = kills.get(point)
        if n is not None and _hits[point] >= n:
            _fired[point] = _fired.get(point, 0) + 1
            _suicide(point)  # does not return
        f = _armed.get(point)
        if f is None:
            return
        if f.skip > 0:
            f.skip -= 1
            return
        if f.times <= 0:
            return
        f.times -= 1
        if f.times <= 0:
            del _armed[point]
        _fired[point] = _fired.get(point, 0) + 1
        latency = f.latency_s
        exc = _make_exc(f.exc, point)
    # sleep OUTSIDE the lock: a latency injection must not serialize
    # every other kill-point in the process behind it
    if latency:
        time.sleep(latency)
    _on_fired(point, exc)
    if exc is not None:
        raise exc


def _on_fired(point, exc=None):
    """A kill point fired: leave evidence before the injected exception
    unwinds, a zero-width span at the kill site, a run-log event and,
    when the flight recorder is armed, an atomic crash dump whose last
    span is this one (the injected exception rides into the dump, so an
    injected allocation failure classifies as ``reason="oom"``). Never
    raises: injecting the configured fault is the contract."""
    try:
        from ..observability import flight, runlog, tracing
        now = tracing.now_ns()
        if tracing.enabled("user"):
            # record_span fans out to the profiler, the flight ring and
            # the run-log
            tracing.record_span(f"fault/{point}", "user", now, now,
                                kill_point=point)
        else:
            # evidence even with tracing off: the flight ring is always on
            flight.record(f"fault/{point}", "user", now, now, 0, 0, 0,
                          {"kill_point": point})
        runlog.event("fault_fired", point=point)
        if flight.installed():
            flight.on_kill_point(point, exc)
    except Exception:
        pass


class scoped:
    """Context manager: arm on enter, disarm on exit (exception-safe).

    >>> with faults.scoped("checkpoint/data_partial"):
    ...     manager.save(7)   # raises FaultInjected mid-payload
    """

    def __init__(self, point, **kwargs):
        self.point = point
        self.kwargs = kwargs

    def __enter__(self):
        inject(self.point, **self.kwargs)
        return self

    def __exit__(self, *exc):
        clear(self.point)
        return False
