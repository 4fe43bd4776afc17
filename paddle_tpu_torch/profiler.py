"""Host profiler and op tracing (counterpart: ``paddle_tpu/profiler.py``).

One event buffer in this module holds everything a chrome trace shows:
``RecordEvent`` ranges, the per-op events of the op seam
(``_OpProfObserver``, registered at ``core.dispatch`` while profiling),
the spans of ``observability.tracing`` (which records into this buffer
and keeps none of its own) and, after a device trace, the card's kernels.
The reference keeps its host half in a native runtime
(``_native/src/pt_runtime.cc``); the port has no native runtime, so the
buffer is this module's Python list.

The device timeline: the reference maps it to jax's XPlane trace; the
port maps it to ``torch.profiler`` with CUDA activity. With
``state="GPU"`` or ``"All"`` on the card, ``start_profiler`` also starts a
``torch.profiler`` trace, and ``stop_profiler`` merges its kernels,
copies and fills into the buffer on the host clock (aligned through an
anchor range recorded in both). The three flash kernels take the
reference's names (``flash_attention_fwd``, ``..._bwd_dq``,
``..._bwd_dkv``); the CUDA function's name stays in ``args.kernel``.

``PADDLE_TPU_PROF_MAX_EVENTS`` caps the buffer (default 1,000,000);
events past the cap are counted in :func:`dropped_events`.
"""
import contextlib
import json
import os
import tempfile
import threading
import time

import torch

from .core import dispatch

__all__ = [
    "RecordEvent", "profiler", "start_profiler", "stop_profiler",
    "export_chrome_tracing", "summary", "Profiler", "reset",
    "dropped_events",
]

_MAX_EVENTS = int(os.environ.get("PADDLE_TPU_PROF_MAX_EVENTS", 1_000_000))

# (name, cat, start_ns, end_ns, tid, args, span) in the order recorded;
# span = (trace_id, span_id, parent_id, attrs) for a tracing span
_events = []
_lock = threading.Lock()
# recording is on while tracing collects spans or a profiler runs
_collecting = [False]
_profiling = [False]
_event_count = [0]
_dropped_events = [0]
_device = [None]  # the active _DeviceTrace


def _now_ns():
    """The host clock of every event: monotonic nanoseconds."""
    return time.monotonic_ns()


def _admit():
    if _event_count[0] >= _MAX_EVENTS:
        _dropped_events[0] += 1
        return False
    _event_count[0] += 1
    return True


def dropped_events():
    """Events discarded since the last :func:`reset` because the buffer
    cap (``PADDLE_TPU_PROF_MAX_EVENTS``) was reached."""
    return _dropped_events[0]


def _tid():
    return threading.get_ident() % (1 << 31)


def _record(name, cat, start_ns, end_ns, args=None, span=None, tid=None):
    with _lock:
        if not _admit():
            return
        _events.append((name, cat, int(start_ns), int(end_ns),
                        _tid() if tid is None else tid, args, span))


def enable_collection():
    """Turn on event recording without the op observer: the
    observability layer's seam (spans go to this buffer; per-op events
    stay opt-in)."""
    _collecting[0] = True


def disable_collection():
    _collecting[0] = False


def record_span(name, cat, start_ns, end_ns, attrs=None, span=None):
    """Record a completed span (``observability.tracing``'s emission
    point). ``span`` carries ``(trace_id, span_id, parent_id, attrs)``
    for :func:`spans`."""
    if not (_collecting[0] or _profiling[0]):
        return
    _record(name, cat, start_ns, end_ns, attrs, span)


def spans():
    """The tracing spans in the buffer, oldest first, as dicts
    (``name``, ``cat``, ``t0``, ``t1``, ``trace_id``, ``span_id``,
    ``parent_id``, ``attrs``)."""
    with _lock:
        evs = list(_events)
    return [{"name": n, "cat": c, "t0": s, "t1": e, "trace_id": sp[0],
             "span_id": sp[1], "parent_id": sp[2], "attrs": sp[3] or {}}
            for (n, c, s, e, _t, _a, sp) in evs if sp is not None]


def events():
    """Every buffered event as ``(name, cat, start_ns, end_ns, tid,
    args)``."""
    with _lock:
        return [ev[:6] for ev in _events]


class RecordEvent:
    """RAII host event (the reference's ``RecordEvent``)."""

    def __init__(self, name, cat="user"):
        self.name = name
        self.cat = cat
        self._t0 = None

    def __enter__(self):
        if _collecting[0] or _profiling[0]:
            self._t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            _record(self.name, self.cat, self._t0, _now_ns())
            self._t0 = None
        return False

    begin = __enter__

    def end(self):
        self.__exit__()


class _OpProfObserver:
    """One host event per op through the op seam; while a device trace
    runs, each op is also a ``torch.profiler`` range, so the device
    timeline carries the op's name."""

    def begin(self, name):
        rf = None
        if _device[0] is not None:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        return (_now_ns(), rf)

    def end(self, token, name, outputs):
        start, rf = token
        if rf is not None:
            rf.__exit__(None, None, None)
        _record(name, "op", start, _now_ns())


# device event categories of a torch.profiler chrome trace that are kept
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_ANCHOR = "paddle_tpu_torch::profiler_anchor"


def _kernel_names():
    """CUDA function name -> the reference's kernel name."""
    from .kernels import flash_attention
    return flash_attention.CUDA_FUNCTIONS


class _DeviceTrace:
    """A ``torch.profiler`` trace with CUDA activity, merged into the
    buffer when it stops."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.anchor_ns = None

    def start(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        with torch.profiler.record_function(_ANCHOR):
            self.anchor_ns = _now_ns()

    def stop(self):
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "device.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        evs = trace.get("traceEvents", trace) if isinstance(
            trace, dict) else trace
        anchor = next((e for e in evs if e.get("name") == _ANCHOR
                       and e.get("ph") == "X"), None)
        if anchor is None:
            raise RuntimeError("the device trace lost its anchor range")
        offset_ns = self.anchor_ns - int(float(anchor["ts"]) * 1e3)
        names = _kernel_names()
        n = 0
        for e in evs:
            if e.get("ph") != "X" or e.get("cat") not in _DEVICE_CATS:
                continue
            t0 = int(float(e["ts"]) * 1e3) + offset_ns
            t1 = t0 + int(float(e.get("dur", 0)) * 1e3)
            raw = e.get("name", "")
            name = next((ref for fn, ref in names.items()
                         if fn in raw), raw)
            args = {"kernel": raw} if name != raw else {}
            stream = (e.get("args") or {}).get("stream", e.get("tid", 0))
            _record(name, e["cat"], t0, t1, args or None,
                    tid=f"device {e.get('pid', 0)} stream {stream}")
            n += 1
        return n


def start_profiler(state="All", tracer_option="Default"):
    """The reference's ``start_profiler``: host events on, the per-op
    observer registered; with ``state`` ``"GPU"`` or ``"All"`` on the
    card, a device trace too."""
    _profiling[0] = True
    dispatch.add_observer("profiler", _OpProfObserver())
    if (state in ("GPU", "All") and _device[0] is None
            and torch.cuda.is_available()):
        dev = _DeviceTrace()
        dev.start()
        _device[0] = dev


def stop_profiler(sorted_key=None, profile_path=None):
    """The reference's ``stop_profiler``: the observer removed, a device
    trace merged, events kept for export; prints the per-op table when
    ``sorted_key`` is given."""
    dispatch.remove_observer("profiler")
    dev, _device[0] = _device[0], None
    if dev is not None:
        dev.stop()
    _profiling[0] = False
    if sorted_key:
        print(summary())


def _chrome_events():
    pid = os.getpid()
    out = []
    for (n, c, s, e, t, a, sp) in list(_events):
        ev = {"name": n, "cat": c, "ph": "X", "ts": s / 1e3,
              "dur": (e - s) / 1e3, "pid": pid, "tid": t}
        args = dict(a or {})
        if sp is not None:
            trace_id, span_id, parent_id, attrs = sp
            args = {"trace_id": f"{trace_id:016x}",
                    "span_id": f"{span_id:016x}"}
            if parent_id:
                args["parent_id"] = f"{parent_id:016x}"
            if attrs:
                args.update(attrs)
        if args:
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                              else str(v)) for k, v in args.items()}
        out.append(ev)
    return out


def export_chrome_tracing(path):
    """Write the buffer as chrome://tracing JSON; returns the event
    count."""
    with _lock:
        evs = _chrome_events()
    with open(path, "w") as f:
        json.dump({"traceEvents": evs}, f)
    return len(evs)


def reset():
    """Drop every buffered event and the dropped-event count."""
    with _lock:
        _events.clear()
        _event_count[0] = 0
        _dropped_events[0] = 0


def summary():
    """Aggregated per-event table: name, calls, total ms, max ms (sorted
    by total); the reference's ``PrintProfiler``."""
    agg = {}
    with _lock:
        evs = list(_events)
    for (name, _c, s, e, _t, _a, _sp) in evs:
        a = agg.setdefault(name, [0, 0, 0])
        a[0] += 1
        a[1] += e - s
        a[2] = max(a[2], e - s)
    rows = sorted(((k, v[0], v[1], v[2]) for k, v in agg.items()),
                  key=lambda r: -r[2])
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Max(ms)':>12}"]
    for name, calls, total, mx in rows:
        lines.append(f"{name:<40}{calls:>8}{total/1e6:>12.3f}{mx/1e6:>12.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None):
    """The reference's ``profiler`` context manager."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


class Profiler:
    """``paddle.profiler.Profiler``'s shape: ``start``/``stop``/``step``/
    ``summary``/``export``. ``targets`` (``["CPU"]``, ``["CPU", "GPU"]``)
    or ``state`` (``"CPU"``, ``"GPU"``, ``"All"``) picks the device
    trace; the default is the host only, as the reference's default is
    (its device trace needs ``trace_dir``)."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 trace_dir=None, state=None):
        if state is None:
            t = {str(x).upper() for x in (targets or ("CPU",))}
            state = "All" if ("GPU" in t or trace_dir) else "CPU"
        self.state = state
        self.on_trace_ready = on_trace_ready
        self.trace_dir = trace_dir
        self._step = 0

    def start(self):
        start_profiler(self.state)

    def stop(self):
        stop_profiler()
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)
            export_chrome_tracing(os.path.join(
                self.trace_dir, f"trace_{os.getpid()}.json"))
        if self.on_trace_ready:
            self.on_trace_ready(self)

    def step(self):
        self._step += 1

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self, **kwargs):
        return summary()

    def export(self, path, format="json"):
        return export_chrome_tracing(path)
