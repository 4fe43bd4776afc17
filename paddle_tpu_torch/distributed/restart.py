"""Shared restart policy: bounded budget + exponential backoff + jitter
(counterpart: ``paddle_tpu/distributed/restart.py``, the port's own copy:
the same seed gives the same schedule).

One policy object serves every relaunch surface in the runtime — the
:class:`~paddle_tpu_torch.distributed.pod.PodSupervisor` respawning reaped
pod ranks, :class:`~paddle_tpu_torch.testing.virtual_pod.VirtualPod`'s
watchdog in the chaos tier, and the
:meth:`~paddle_tpu_torch.distributed.fleet.elastic.ElasticManager.relaunch`
KV-watch loop (the reference's ``elastic.py watch:316`` restart path).
Factoring it here keeps all of them honest about the two things a
respawn loop MUST have:
enforces their presence):

- a **bounded budget**: a crash-looping rank must not be relaunched
  forever — after ``max_restarts`` restarts (optionally within a
  sliding ``window_s``), :meth:`schedule` returns ``None`` and the
  caller leaves the pod degraded instead of burning the machine;
- **exponential backoff with jitter**: each consecutive restart of the
  same key waits ``base_delay * factor**n`` (capped at ``max_delay``),
  scaled by a symmetric jitter drawn from a **seedable** RNG — tests
  replay deterministically, production desynchronizes a fleet of
  supervisors respawning after a shared-cause outage.

Keys are arbitrary (a pod origin id, an elastic endpoint, a table
name); each key carries its own attempt history.
"""
import random
import threading
import time

__all__ = ["RestartPolicy"]


class RestartPolicy:
    """Budgeted exponential-backoff restart pacing (see module
    docstring).

    >>> policy = RestartPolicy(max_restarts=3, base_delay=0.2, seed=0)
    >>> delay = policy.schedule(origin)   # None = budget exhausted
    >>> if delay is not None:
    ...     time.sleep(delay); respawn(origin)
    """

    def __init__(self, max_restarts=3, base_delay=0.2, factor=2.0,
                 max_delay=30.0, jitter=0.25, window_s=None, seed=None):
        if max_restarts < 1:
            raise ValueError("max_restarts must be >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.max_restarts = int(max_restarts)
        self.base_delay = float(base_delay)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.window_s = None if window_s is None else float(window_s)
        self._rng = random.Random(seed)
        self._attempts = {}  # key -> [attempt wall times]
        self._lock = threading.Lock()

    def schedule(self, key="default", now=None):
        """Record one restart attempt for ``key`` and return the backoff
        delay (seconds) to wait before relaunching — or ``None`` when
        the budget is exhausted (the attempt is NOT recorded then, so a
        later :meth:`reset` or window expiry re-opens it)."""
        now = time.time() if now is None else float(now)
        with self._lock:
            hist = self._attempts.setdefault(str(key), [])
            if self.window_s is not None:
                hist[:] = [t for t in hist if now - t <= self.window_s]
            if len(hist) >= self.max_restarts:
                return None
            n = len(hist)
            hist.append(now)
            delay = min(self.max_delay, self.base_delay * self.factor ** n)
            if self.jitter:
                delay *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
            return delay

    def attempts(self, key="default"):
        """Restart attempts recorded for ``key`` (within the window when
        one is configured — expired attempts age out lazily on the next
        :meth:`schedule`)."""
        with self._lock:
            return len(self._attempts.get(str(key), ()))

    def reset(self, key=None):
        """Forget the attempt history for one key — call after a
        respawned process has proven stable — or for all keys
        (``key=None``)."""
        with self._lock:
            if key is None:
                self._attempts.clear()
            else:
                self._attempts.pop(str(key), None)

    def snapshot(self):
        """JSON-ready view: per-key attempt counts + the knobs."""
        with self._lock:
            return {
                "max_restarts": self.max_restarts,
                "base_delay": self.base_delay,
                "factor": self.factor,
                "max_delay": self.max_delay,
                "jitter": self.jitter,
                "window_s": self.window_s,
                "attempts": {k: len(v) for k, v in self._attempts.items()},
            }
