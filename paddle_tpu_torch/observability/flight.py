"""Crash flight recorder: a bounded ring of recent spans dumped on death
(counterpart: ``paddle_tpu/observability/flight.py``, the port's own copy;
``memory``'s section reads the port's state and CUDA-graph programs, and
an out-of-memory error is torch's).

When a process dies — unhandled exception, fatal signal, or a fired
chaos kill-point — the in-memory trace evidence dies with it unless
something writes it out at the moment of failure. This module keeps a
bounded ring of the most recent completed spans (fed by the tracing
layer; O(1) append, fixed memory) and, on a death signal, dumps

- the span ring (most recent last),
- a metrics snapshot (counters + gauges + summaries),
- the fault-injection state (armed points, hit/fired counters),
- the failure itself (exception type/message/traceback, signal, or
  kill-point name)

as one JSON file written with the checkpoint core's tmp+rename
discipline (flush + fsync + atomic ``os.replace``), so a dump is either
complete or absent — never torn.

Arming: ``install(dir)`` explicitly, or set ``PADDLE_TPU_FLIGHT_DIR``
and call ``observability.enable()``. Installed hooks chain to the
pre-existing ones (``sys.excepthook``, ``threading.excepthook``,
``SIGTERM``). A fired kill-point (``testing.faults``) triggers a dump
*before* the injected exception unwinds, so the evidence exists even if
the exception is swallowed upstream.
"""
import collections
import json
import os
import signal
import sys
import threading
import traceback

from .. import _lockwatch as _lockwatch_mod

__all__ = ["install", "uninstall", "installed", "dump", "record",
           "recent_spans", "clear", "DEFAULT_RING"]

DEFAULT_RING = 512

_lock = _lockwatch_mod.Lock(name="flight.ring")
_ring = collections.deque(maxlen=DEFAULT_RING)
_dir = [None]           # dump directory; None = not installed
_seq = [0]
_hooks_installed = [False]
_prev_excepthook = [None]
_prev_threading_hook = [None]
_prev_sigterm = [None]


def record(name, cat, t0, t1, trace_id, span_id, parent_id, attrs=None):
    """Append one completed span to the ring (tracing's emission hook).
    Always cheap: a deque append of a tuple, bounded memory."""
    _ring.append((name, cat, int(t0), int(t1), trace_id, span_id,
                  parent_id, attrs))


def recent_spans():
    """The ring as JSON-ready dicts, oldest first."""
    out = []
    for (name, cat, t0, t1, tr, sp, pa, attrs) in list(_ring):
        d = {"name": name, "cat": cat, "t0": t0, "dur": t1 - t0,
             "trace": f"{tr:016x}", "span": f"{sp:016x}"}
        if pa:
            d["parent"] = f"{pa:016x}"
        if attrs:
            d["attrs"] = {k: (v if isinstance(v, (int, float, str, bool,
                                                  list)) else str(v))
                          for k, v in attrs.items()}
        out.append(d)
    return out


def clear():
    _ring.clear()


def set_ring_size(n):
    """Resize the span ring (keeps the newest entries)."""
    global _ring
    with _lock:
        _ring = collections.deque(_ring, maxlen=max(16, int(n)))


def installed():
    return _dir[0] is not None


def install(dir, ring=None):
    """Arm the recorder: dumps go to ``dir``; installs the exception /
    signal hooks once (idempotent; hooks chain to their predecessors)."""
    os.makedirs(dir, exist_ok=True)
    _dir[0] = dir
    if ring:
        set_ring_size(ring)
    _install_hooks()
    return dir


def uninstall():
    """Disarm dumps (hooks stay installed but become no-ops)."""
    _dir[0] = None


def maybe_install_from_env():
    if _dir[0] is None:
        d = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
        if d:
            install(d)


def _faults_snapshot():
    try:
        from ..testing import faults
        return faults.snapshot()
    except Exception:
        return None


def _metrics_snapshot():
    try:
        from .. import monitor
        from . import export
        return {"counters": monitor.stats(), "gauges": export.gauges(),
                "summaries": export.summaries()}
    except Exception as e:
        return {"error": str(e)[:300]}


def _memory_section():
    try:
        from . import memory
        return memory.flight_section()
    except Exception as e:
        return {"error": str(e)[:300]}


def _lockwatch_section():
    """Lock-order watchdog snapshot (edge graph, per-thread held sets,
    recorded violations) — present in every dump while the watchdog is
    armed, so a ``pod_failure`` / crash post-mortem shows who held what
    at death. None (section absent) when disarmed."""
    try:
        if not _lockwatch_mod.enabled():
            return None
        return _lockwatch_mod.snapshot()
    except Exception as e:
        return {"error": str(e)[:300]}


def _classify(reason, exc):
    """Recognize allocation failures: a dump whose exception is an
    allocation failure (``torch.OutOfMemoryError``, the CUDA caching
    allocator's message, ``MemoryError``) is tagged ``reason="oom"`` so dump triage can route
    OOMs to the memory snapshot instead of the traceback."""
    try:
        from . import memory
        if memory.is_oom_error(exc):
            return "oom"
    except Exception:
        pass
    return reason


def dump(reason, exc=None, extra=None):
    """Write one flight-recorder dump; returns the path (None when not
    installed). Atomic tmp+rename — a reader never sees a torn dump.
    Never raises: the recorder must not mask the original failure.
    An exception classified as an allocation failure retags the dump
    ``reason="oom"`` (the triggering path stays in ``cause``); every
    dump carries a ``memory`` section — per-category state-residency
    bytes plus the recorded per-program attributions with their top
    buffers — so an OOM names where the device memory went at death."""
    d = _dir[0]
    if d is None:
        return None
    try:
        import time
        tagged = _classify(reason, exc)
        rec = {"format": 1, "reason": tagged, "pid": os.getpid(),
               "time": time.time(),
               "thread": threading.current_thread().name,
               "spans": recent_spans(),
               "metrics": _metrics_snapshot(),
               "memory": _memory_section(),
               "faults": _faults_snapshot()}
        lw = _lockwatch_section()
        if lw is not None:
            rec["lockwatch"] = lw
        if tagged != reason:
            rec["cause"] = reason
        if exc is not None:
            rec["exception"] = {
                "type": type(exc).__name__, "message": str(exc)[:2000],
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-8000:]}
        if extra:
            rec.update(extra)
        with _lock:
            _seq[0] += 1
            n = _seq[0]
        path = os.path.join(d, f"flight_{os.getpid()}_{n:04d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def on_kill_point(point, exc=None):
    """testing.faults hook: a kill-point FIRED. Called before the
    injected exception is raised so the evidence outlives it. The
    injected exception rides along so a synthetic allocation failure
    classifies as ``reason="oom"`` exactly like a real one."""
    dump("kill_point", exc=exc, extra={"kill_point": point})


def latest_dump(dir=None):
    """Path of the newest dump in ``dir`` (default: the installed dir),
    or None."""
    d = dir or _dir[0]
    if d is None or not os.path.isdir(d):
        return None
    dumps = sorted(f for f in os.listdir(d)
                   if f.startswith("flight_") and f.endswith(".json"))
    return os.path.join(d, dumps[-1]) if dumps else None


# -- death hooks ----------------------------------------------------------

def _install_hooks():
    if _hooks_installed[0]:
        return
    _hooks_installed[0] = True

    _prev_excepthook[0] = sys.excepthook

    def _excepthook(etype, value, tb):
        if _dir[0] is not None:
            if value is not None and value.__traceback__ is None:
                value.__traceback__ = tb
            dump("unhandled_exception", exc=value)
        (_prev_excepthook[0] or sys.__excepthook__)(etype, value, tb)

    sys.excepthook = _excepthook

    _prev_threading_hook[0] = threading.excepthook

    def _thread_hook(args):
        if _dir[0] is not None and args.exc_type is not SystemExit:
            dump("unhandled_thread_exception", exc=args.exc_value,
                 extra={"thread": getattr(args.thread, "name", "?")})
        prev = _prev_threading_hook[0]
        if prev is not None:
            prev(args)

    threading.excepthook = _thread_hook

    # fatal-signal hook: SIGTERM is the preemption path (a scheduler
    # evicting a worker). Only the main thread may set signal handlers;
    # a non-main install skips this hook rather than failing.
    try:
        _prev_sigterm[0] = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            if _dir[0] is not None:
                dump("signal", extra={"signal": "SIGTERM"})
            prev = _prev_sigterm[0]
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                pass  # the process deliberately ignored SIGTERM before
                # install(); dumping must not convert ignore into death
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass
