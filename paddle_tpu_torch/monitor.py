"""Global counters (counterpart: ``paddle_tpu/monitor.py``, the
reference's ``StatRegistry``): named integer counters in one process-wide
registry. The reference's C++ registry (``_native``) is not ported; this
is its Python registry."""
import threading

__all__ = ["stat_add", "stat_get", "stat_reset", "stats"]

_lock = threading.Lock()
_stats = {}


def stat_add(name, value=1):
    with _lock:
        _stats[name] = _stats.get(name, 0) + int(value)


def stat_get(name):
    with _lock:
        return _stats.get(name, 0)


def stat_reset(name):
    with _lock:
        _stats[name] = 0


def stats():
    """Every counter as a dict."""
    with _lock:
        return dict(_stats)
