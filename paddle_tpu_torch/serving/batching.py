"""Concurrent dynamic request batcher (counterpart:
``paddle_tpu/serving/batching.py``, ported as is; its condition variable is
a plain ``threading.Condition``).

Reference: the reference serves concurrency by cloning predictors per
thread (`analysis_predictor.cc` Clone + thread-local scopes) — every
caller pays a full device step. The design here inverts that: ONE
device stream, and a coalescing queue in front of it. Callers enqueue
(inputs, future) pairs; a worker drains the queue into per-step batches
bounded by ``max_batch_size`` and flushed after ``batch_timeout_ms`` —
so throughput scales with offered concurrency (fill the bucket) while a
lone request still sees at most one timeout of added latency.

Graceful degradation (the load-shedding half of the serving SLO story):

- ``max_pending`` bounds the queue — an unbounded queue under overload
  converts every request into a late request; admission control converts
  the excess into FAST failures (:class:`OverloadedError` at submit)
  that a load balancer can route elsewhere.
- per-request deadlines — a request that waited past its deadline is
  resolved exceptionally (:class:`DeadlineExceeded`) the moment the
  worker sees it, instead of burning a device step on an answer the
  caller already abandoned.

The batcher is engine-agnostic: it owns ONLY queueing/coalescing and
future resolution; the engine supplies ``run_batch(requests)`` which must
resolve every request's future (the batcher resolves them exceptionally
if ``run_batch`` itself raises, so a caller can never hang on a crashed
device step).
"""
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

from ..core import dispatch as _dispatch

__all__ = ["Request", "DynamicBatcher", "OverloadedError",
           "DeadlineExceeded"]


class OverloadedError(RuntimeError):
    """Submit rejected: the pending queue is at ``max_pending`` (load
    shed). The request was NOT enqueued; retry against another replica
    or after backoff."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline lapsed while it waited in the queue."""


class Request:
    """One enqueued inference request: per-input arrays (batch-major),
    row count, the caller's future, and an optional absolute deadline
    (``time.perf_counter()`` seconds). ``ctx``/``t0_ns`` are the tracing
    identity (``tracing.mint_context()``) and start of the request's span,
    set by the engine when serving tracing is on."""

    __slots__ = ("inputs", "rows", "future", "t_enqueue", "deadline",
                 "ctx", "t0_ns")

    def __init__(self, inputs, rows, deadline=None):
        self.inputs = inputs
        self.rows = rows
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline
        self.ctx = None
        self.t0_ns = 0


class DynamicBatcher:
    """``on_start``, if given, runs on the worker thread before it serves
    anything; ``started`` is a future that resolves when it has (or holds
    its exception, and the worker exits)."""

    def __init__(self, run_batch, max_batch_size, batch_timeout_ms,
                 name="paddle-tpu-torch-serving", max_pending=None,
                 on_expired=None, on_start=None):
        self._run_batch = run_batch
        self._on_start = on_start
        self.started = Future()
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.max_pending = None if max_pending is None else int(max_pending)
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}")
        self._on_expired = on_expired
        self._q = deque()
        self._cond = threading.Condition()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, request):
        expired = []
        try:
            with self._cond:
                if not self._running:
                    raise RuntimeError("batcher is closed")
                # prune dead head entries first: deadline-lapsed /
                # cancelled requests the worker would discard anyway must
                # not hold max_pending slots against live traffic (and
                # their callers learn NOW, not after the in-flight step)
                now = time.perf_counter()
                while self._q and self._dead(self._q[0], now, expired):
                    self._q.popleft()
                if self.max_pending is not None \
                        and len(self._q) >= self.max_pending:
                    # fast-fail load shed: nothing was enqueued, the
                    # caller learns NOW instead of after a hopeless wait
                    raise OverloadedError(
                        f"request shed: {len(self._q)} request(s) "
                        f"already pending (max_pending={self.max_pending})")
                self._q.append(request)
                self._cond.notify()
        finally:
            self._resolve_expired(expired)  # outside the lock
        return request.future

    def pending(self):
        with self._cond:
            return len(self._q)

    def alive(self):
        """Is the worker thread serviceable (running and not crashed)?"""
        return self._thread.is_alive() and self._running

    def close(self, timeout=30):
        """Stop accepting requests; the worker drains what is already
        queued (every accepted future resolves) and exits. Raises if the
        drain does not finish within `timeout` — a silent return here
        would leave callers blocked on futures a dying daemon thread
        will never resolve."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                f"batcher drain did not finish within {timeout}s "
                f"({self.pending()} request(s) still queued); a device "
                "step may be stuck — outstanding futures are unresolved")

    # -- worker ------------------------------------------------------------
    @staticmethod
    def _dead(r, now, expired):
        """Is this queued request not worth serving? A lapsed deadline
        collects into ``expired`` (resolved by the caller OUTSIDE the
        lock); a caller-cancelled future is dropped silently (the chunk
        roll-back path cancels admitted siblings). Caller holds the
        lock."""
        if r.future.cancelled():
            return True
        if r.deadline is not None and now > r.deadline:
            expired.append(r)
            return True
        return False

    def _pop_live(self, expired):
        """Pop the first serveable request, collecting dead ones on the
        way. Caller holds the lock. Returns None when the queue runs
        dry."""
        now = time.perf_counter()
        while self._q:
            r = self._q.popleft()
            if not self._dead(r, now, expired):
                return r
        return None

    def _take_compatible(self, batch, rows, expired):
        """Move queue-head requests into `batch` while they fit (dead
        ones collect/drop). Caller holds the lock. Returns the new row
        total."""
        now = time.perf_counter()
        while self._q:
            head = self._q[0]
            if self._dead(head, now, expired):
                self._q.popleft()
                continue
            if rows + head.rows > self.max_batch_size:
                break
            self._q.popleft()
            batch.append(head)
            rows += head.rows
        return rows

    def _resolve_expired(self, expired):
        """Resolve deadline-lapsed requests. MUST run without the lock:
        set_exception fires caller done-callbacks synchronously, and one
        that calls back into the batcher (pending(), a fallback submit)
        would self-deadlock the worker."""
        for r in expired:
            try:
                r.future.set_exception(DeadlineExceeded(
                    f"request waited "
                    f"{(time.perf_counter() - r.t_enqueue) * 1e3:.1f} ms "
                    "in queue, past its deadline"))
            except InvalidStateError:
                pass  # caller cancelled while queued
            if self._on_expired is not None:
                self._on_expired(r)

    def _loop(self):
        try:
            if self._on_start is not None:
                self._on_start()
        except BaseException as e:  # noqa: BLE001 -- the starter re-raises
            with self._cond:
                self._running = False
            self.started.set_exception(e)
            return
        self.started.set_result(None)
        while True:
            expired = []
            batch = None
            drained = False
            with self._cond:
                while not self._q and self._running:
                    # bounded idle wait + predicate re-check: a missed
                    # notify (close() racing an exception path) must
                    # degrade to a 0.5 s late wake, not a worker hung
                    # forever on futures nobody will resolve
                    self._cond.wait(timeout=0.5)
                first = self._pop_live(expired)
                if first is None:
                    if not self._running and not self._q:
                        drained = True  # closed and drained
                    # else: everything queued was dead; wait again
                else:
                    batch = [first]
                    rows = self._take_compatible(batch, first.rows,
                                                 expired)
                    deadline = time.perf_counter() + self.batch_timeout_s
                    # coalescing window: wait for more traffic until the
                    # batch is full, the timeout lapses, or close() drains
                    while rows < self.max_batch_size and self._running:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        if not self._q:
                            self._cond.wait(remaining)
                        rows = self._take_compatible(batch, rows, expired)
                        if self._q and rows + self._q[0].rows \
                                > self.max_batch_size:
                            break  # head doesn't fit: serve now, it waits
            self._resolve_expired(expired)  # outside the lock
            if drained:
                return
            if batch is None:
                continue
            _dispatch.sync_thread()  # this thread's op-observer mode
            try:
                self._run_batch(batch)
            except BaseException as e:  # noqa: BLE001 — futures must resolve
                for r in batch:
                    try:
                        r.future.set_exception(e)
                    except InvalidStateError:
                        pass  # already resolved or caller cancelled
