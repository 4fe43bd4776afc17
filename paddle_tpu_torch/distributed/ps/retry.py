"""Bounded retry with exponential backoff + jitter + per-call deadlines
(counterpart: ``paddle_tpu/distributed/ps/retry.py``).

The reference retries only the PS *connect* path (brpc_ps_client.cc
under FLAGS_pserver_connect_timeout_ms); mid-call failures surface raw.
This policy object is the one place the client's failure handling is
specified: attempts are bounded, sleeps grow exponentially up to a cap,
jitter de-synchronizes a worker fleet hammering a restarting server
(decorrelated thundering herd), and a per-call deadline bounds the
worst-case latency a caller can see. The jitter RNG is seedable so chaos
tests replay the exact same backoff schedule deterministically.

Retries are only safe for idempotent requests; the PS client makes its
push family idempotent via server-side request-id dedup (see client.py)
so everything except the barrier can ride this policy.
"""
import random
import time

from ... import monitor as _monitor

__all__ = ["RetryPolicy", "DeadlineExceeded", "RetriesExhausted"]


class DeadlineExceeded(ConnectionError):
    """The per-call deadline lapsed before an attempt succeeded.
    Subclasses ConnectionError so existing PS failure handlers catch it."""


class RetriesExhausted(ConnectionError):
    """Every allowed attempt failed; the last cause is chained."""


class RetryPolicy:
    """``run(fn)`` calls ``fn()`` up to ``max_attempts`` times.

    Backoff before attempt k (k >= 2) is
    ``base_delay_s * multiplier**(k-2)`` capped at ``max_delay_s``, then
    scaled by a symmetric jitter factor in ``[1-jitter, 1+jitter]``. If
    the next sleep would cross ``deadline_s`` (measured from the first
    attempt), :class:`DeadlineExceeded` is raised instead of sleeping —
    a deadline miss fails FAST, it does not fail late.

    ``seed`` pins the jitter sequence (chaos tests); ``sleep``/``clock``
    are injectable for the same reason.
    """

    def __init__(self, max_attempts=5, base_delay_s=0.05, max_delay_s=2.0,
                 multiplier=2.0, jitter=0.5, deadline_s=15.0, seed=None,
                 sleep=time.sleep, clock=time.monotonic):
        if int(max_attempts) < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if not 0.0 <= float(jitter) < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline_s = float(deadline_s)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def backoff_s(self, attempt):
        """Jittered sleep before attempt ``attempt`` (2-based; attempt 1
        never sleeps)."""
        if attempt <= 1:
            return 0.0
        d = min(self.base_delay_s * self.multiplier ** (attempt - 2),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return d

    def run(self, fn, retriable=(ConnectionError, OSError), on_retry=None,
            what="call"):
        """Run ``fn`` under this policy. ``on_retry(attempt, delay_s,
        exc)`` fires before each backoff sleep (telemetry hook)."""
        start = self._clock()
        last = None
        for attempt in range(1, self.max_attempts + 1):
            if attempt > 1:
                delay = self.backoff_s(attempt)
                remaining = self.deadline_s - (self._clock() - start)
                if remaining <= delay:
                    raise DeadlineExceeded(
                        f"{what}: deadline of {self.deadline_s:.3f}s "
                        f"would lapse before retry {attempt}/"
                        f"{self.max_attempts} (last error: {last})"
                    ) from last
                if on_retry is not None:
                    on_retry(attempt, delay, last)
                # always-on counter: a fleet quietly riding its retry
                # budget is exactly what this metric exists to expose
                _monitor.stat_add("ps_retry_total", 1)
                self._sleep(delay)
            try:
                return fn()
            except retriable as e:
                last = e
                if self._clock() - start >= self.deadline_s:
                    raise DeadlineExceeded(
                        f"{what}: deadline of {self.deadline_s:.3f}s "
                        f"lapsed at attempt {attempt}/{self.max_attempts}"
                    ) from e
        raise RetriesExhausted(
            f"{what}: all {self.max_attempts} attempts failed "
            f"(last error: {last})") from last
