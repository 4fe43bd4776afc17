"""Asynchronous pipeline stages for the device embedding cache
(counterpart: ``paddle_tpu/distributed/ps/async_cache.py``).

The reference's CTR throughput story (`ps_gpu_wrapper.cc:533`
BuildGPUPSTask + the heter_ps pull/push threads) is not just
device-resident tables — it is *overlap*: embedding rows for the next
pass move host→device while trainer threads chew on the current one,
and trained deltas stream back to the parameter servers behind the next
pass's compute. This module is that overlap, on the card:

- :class:`CachePrefetcher` — a host-side worker that dedupes the NEXT
  window's keys and faults the misses in from the PS (batched, riding
  the client's ``RetryPolicy``) while the device executes the current
  window. Its output is a :class:`WindowPlan`: static-shaped ``(slots,
  inv)`` index feeds, so the k-step program's ``[k, ...]`` inputs never
  change shape and its one captured CUDA graph serves every window. The
  planner thread never touches a device tensor: pulled rows install on
  the consumer thread (``WindowPlan.feeds()``). The output queue is
  bounded (``depth``), which is what bounds in-flight pulls.
- :class:`WriteBackQueue` — a bounded background queue for delta
  pushes (eviction + end-of-pass write-back). Entries coalesce per
  (table, key-range) before hitting the wire — duplicate keys merge by
  summation, exactly the server's composition rule for
  ``push_sparse_delta`` — so pushes overlap the next window's compute
  instead of serializing behind it. A high watermark applies
  *backpressure* (``put`` blocks) instead of letting a slow PS grow the
  queue without bound. Pushes ride the request-id idempotency: a
  retried wire push applies exactly once.

Chaos: the write-back worker passes the ``ps/writeback`` kill-point
before every push batch. A fired kill leaves the batch REQUEUED
(deltas are never lost), surfaces the error on ``put``/``flush``, and
lets the unhandled exception reach the threading excepthook — so an
armed flight recorder dumps with the kill site as the last span.
``restart()`` resumes the queue; the requeued deltas push once.

Overlap telemetry: the prefetcher accounts total plan time (host dedupe
+ PS pull + device install) against the consumer-visible wait in
:meth:`CachePrefetcher.take`; ``overlap_efficiency()`` = the fraction
of that pipeline time hidden behind compute — the number the
``ctr_overlap_efficiency`` bench row reports.
"""
import queue
import sys
import threading
import time

import numpy as np

from ... import _lockwatch as lockwatch
from ... import monitor
from ...testing import faults as _faults

__all__ = ["WindowPlan", "CachePrefetcher", "WriteBackQueue"]


class WindowPlan:
    """Static-shaped slot-index feeds for ONE scan window over one cache.

    ``slots``: int32 ``[k, W]`` — per inner step, the device rows holding
    that step's unique keys, bucket-padded to a fixed width ``W`` (padded
    lanes point at scratch row 0). ``inv``: int32 ``[k, *ids_shape]`` —
    per-element positions into the step's slot list (``np.unique``'s
    inverse). Together they make ``CachedSparseEmbedding`` lookups pure
    static-shaped gathers inside a ``to_static(..., scan_steps=k)`` body.

    The plan PINS its keys against eviction until consumed
    (``cache.drain_window(plan)`` or an explicit :meth:`release`) — a
    prefetched window must survive the windows trained before it.
    """

    __slots__ = ("cache", "slots", "inv", "touched_slots", "keys",
                 "plan_s", "pull_s", "_released")

    def __init__(self, cache, slots, inv, touched_slots, keys,
                 plan_s=0.0, pull_s=0.0):
        self.cache = cache
        self.slots = slots
        self.inv = inv
        self.touched_slots = touched_slots
        self.keys = keys
        self.plan_s = plan_s
        self.pull_s = pull_s
        self._released = False

    @property
    def k(self):
        return self.slots.shape[0]

    def feeds(self):
        """``(slots, inv)`` as int64 tensors on the cache's device — the
        inputs a k-step program consumes (``emb((slots_t, inv_t))``
        inside the body). Flushes the cache's staged installs first, on
        the calling (consumer) thread and its current stream: this is the
        moment the prefetched rows become device-readable, one
        asynchronous install ahead of the window that needs them."""
        cache = self.cache
        cache._flush_installs()
        return (cache._to_device(self.slots.astype(np.int64)),
                cache._to_device(self.inv.astype(np.int64)))

    def release(self):
        """Drop this plan's eviction pins (idempotent; drain_window
        releases automatically)."""
        if not self._released:
            self._released = True
            self.cache._release_pins(self.keys)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


_END = object()


class CachePrefetcher:
    """Double-buffered host-side prefetch pipeline over one or more
    caches that share a key stream (e.g. the deep + wide tables of a
    wide-and-deep model reading the same slot ids).

    ``submit(ids)`` enqueues the NEXT window's ``[k, ...]`` id block and
    returns immediately; a worker thread plans it (dedupe → fault-in →
    install) while the caller's device step runs the CURRENT window.
    ``take()`` returns the oldest finished plan — a dict
    ``{table_id: WindowPlan}`` when constructed with several caches, a
    bare :class:`WindowPlan` for one. ``depth`` bounds finished-but-
    unconsumed windows (and thereby in-flight pulls + pinned rows):
    ``depth=1`` is classic double buffering.
    """

    def __init__(self, caches, depth=2, bucket=None):
        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._single = not isinstance(caches, (list, tuple))
        self.caches = [caches] if self._single else list(caches)
        if any(getattr(c, "sharded", False) for c in self.caches):
            raise ValueError(
                "a cache sharded over a mesh axis plans its windows on the "
                "consumer thread (every rank must take the same slot "
                "decisions in the same order): plan_window directly, or "
                "train with prefetch=False")
        self.bucket = bucket
        self._in = queue.Queue()
        self._out = queue.Queue(maxsize=int(depth))
        self._closing = threading.Event()
        self._error = None
        self.pull_s = 0.0   # total pipeline time (dedupe + pull + install)
        self.wait_s = 0.0   # consumer-visible stall in take()
        self.windows = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hbm-cache-prefetch")
        self._thread.start()

    def submit(self, ids):
        """Enqueue the next window's ``[k, ...]`` ids (host copy taken
        NOW — the caller may reuse/overwrite its buffer)."""
        if self._error is not None:
            raise RuntimeError("cache prefetcher failed") from self._error
        from .embedding import host_array
        self._in.put(np.array(host_array(ids), np.int64, copy=True))

    def _run(self):
        while True:
            ids = self._in.get()
            if ids is _END:
                # close() (the only producer of this sentinel) places
                # its own _END in _out after draining; putting one here
                # too could block forever on a full queue if close()
                # already gave up waiting — just exit
                if not self._closing.is_set():
                    self._out.put(_END)
                return
            try:
                t0 = time.perf_counter()
                plans = {c.table_id: c.plan_window(ids, bucket=self.bucket)
                         for c in self.caches}
                dt = time.perf_counter() - t0
                self.pull_s += dt
                self.windows += 1
                monitor.stat_add("hbm_prefetch_windows", 1)
                monitor.stat_add("hbm_prefetch_ns", int(dt * 1e9))
                item = (plans[self.caches[0].table_id]
                        if self._single else plans)
                if self._closing.is_set():
                    # close() gave up waiting (a slow PS pull outlived
                    # its deadline) — nobody will take this plan; drop
                    # its pins here instead of leaking them forever
                    self._release_plans(item)
                    continue
                self._out.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._error = e
                self._out.put(_END)
                return

    def take(self, timeout=None):
        """Oldest finished plan; blocks only when the pipeline fell
        behind the consumer (that stall is the *unhidden* pull time)."""
        t0 = time.perf_counter()
        item = self._out.get(timeout=timeout)
        wait = time.perf_counter() - t0
        self.wait_s += wait
        monitor.stat_add("hbm_prefetch_wait_ns", int(wait * 1e9))
        if item is _END:
            if self._error is not None:
                raise RuntimeError("cache prefetcher failed") \
                    from self._error
            raise RuntimeError("cache prefetcher closed")
        return item

    def overlap_efficiency(self):
        """Fraction of the prefetch pipeline's time hidden behind the
        consumer's compute: ``1 - wait/pull`` (clamped to [0, 1])."""
        if self.pull_s <= 0.0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - self.wait_s / self.pull_s))

    def reset_stats(self):
        """Zero the overlap accounting (benches call this after their
        warmup window so the unhideable first fill is excluded)."""
        self.pull_s = self.wait_s = 0.0
        self.windows = 0

    def _release_plans(self, item):
        if item is not _END:
            for p in (item.values() if isinstance(item, dict)
                      else (item,)):
                p.release()

    def close(self):
        """Shut the worker down, releasing any finished-but-unconsumed
        plans (and their eviction pins). Safe when the consumer
        abandoned the pipeline mid-run: a worker blocked on the bounded
        output queue is unblocked by draining it, so close() never
        stalls out the join waiting for a put that can't complete.
        Should the worker outlive even the deadline (a PS pull stuck in
        a long retry), it self-releases any plan it finishes after
        this point — abandoned windows never leak their pins."""
        self._closing.set()
        self._in.put(_END)
        deadline = time.monotonic() + 30.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            self._thread.join(timeout=0.05)
            if not self._thread.is_alive():
                break
            try:
                self._release_plans(self._out.get_nowait())
            except queue.Empty:
                pass
        # drop whatever the consumer never took so its pins don't leak;
        # leave one sentinel so a late take() raises instead of hanging.
        # Two rounds: a worker whose put was already in flight when the
        # deadline expired can slip ONE more plan in after the first
        # drain (it checks _closing before any further put); anything
        # beyond that self-releases on GC via WindowPlan.__del__.
        for _ in range(2):
            while True:
                try:
                    self._release_plans(self._out.get_nowait())
                except queue.Empty:
                    break
            try:
                self._out.put_nowait(_END)
                break
            except queue.Full:
                continue


class WriteBackQueue:
    """Bounded background delta write-back with per-(table, key-range)
    coalescing and high-watermark backpressure. See the module docstring
    for the overlap/chaos contract.

    One queue serves every cache on a client (pass it to each
    ``HbmEmbeddingCache(writeback=...)``); coalescing then merges
    same-table deltas from eviction bursts and end-of-pass sweeps into
    few, contiguous-key-range pushes.
    """

    def __init__(self, client, max_pending_rows=1 << 16, range_bits=16,
                 max_rows_per_push=1 << 14):
        self.client = client
        self.max_pending_rows = int(max_pending_rows)
        self.range_bits = int(range_bits)
        self.max_rows_per_push = int(max_rows_per_push)
        self._items = []      # [(table, keys u64, deltas f32[n, dim])]
        self._inflight = []   # taken by the worker, not yet pushed
        self._rows = 0        # enqueued + in-flight rows (backpressure)
        self._mu = lockwatch.Lock(name="wbq.mu")
        self._cv = lockwatch.Condition(self._mu, name="wbq.cv")
        self._stop = False
        self._error = None
        self.pushed_rows = 0
        self.coalesced_rows = 0  # rows merged away before the wire
        self._thread = None
        self.restart()

    # -- producer side ----------------------------------------------------
    def put(self, table, keys, deltas):
        """Enqueue one delta batch. Blocks while the pending-row count
        sits at the high watermark (backpressure — bounded memory beats
        unbounded growth behind a slow PS); raises if the worker died
        (``restart()`` to resume, nothing was lost)."""
        keys = np.array(np.asarray(keys, np.uint64).ravel(), copy=True)
        deltas = np.array(np.asarray(deltas, np.float32), copy=True)
        if keys.size == 0:
            return
        with self._cv:
            while (self._rows + keys.size > self.max_pending_rows
                   and self._rows > 0 and self._error is None
                   and not self._stop):
                monitor.stat_add("hbm_writeback_backpressure", 1)
                self._cv.wait(timeout=0.5)
            if self._error is not None:
                raise RuntimeError(
                    "write-back worker died (deltas requeued, nothing "
                    "lost); call restart() to resume") from self._error
            if self._stop:
                # no worker will ever drain these rows — enqueueing
                # silently would strand the deltas until a flush times out
                raise RuntimeError(
                    "write-back queue is stopped; restart() before "
                    "enqueuing more deltas")
            self._items.append((int(table), keys, deltas))
            self._rows += int(keys.size)
            monitor.stat_add("hbm_writeback_rows_enqueued", int(keys.size))
            self._cv.notify_all()

    @property
    def pending_rows(self):
        with self._mu:
            return self._rows

    def has_pending(self, table, keys):
        """True when any of ``keys`` has an enqueued or in-flight delta
        for ``table`` — the cache's re-fault path checks this and
        flushes first, so a key evicted with an async delta can never be
        re-pulled STALE from the PS (read-your-writes)."""
        keys = np.asarray(keys, np.uint64).ravel()
        if keys.size == 0:
            return False
        with self._mu:
            pending = list(self._items) + list(self._inflight)
        for t, k, _d in pending:
            if t == table and np.isin(keys, k).any():
                return True
        return False

    def flush(self, timeout=120.0):
        """Block until every enqueued delta reached the PS (the end-pass
        'server rows equal device rows' contract). Raises the worker's
        error if it died with deltas pending."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._rows > 0:
                if self._error is not None:
                    raise RuntimeError(
                        "write-back worker died with deltas pending; "
                        "restart() and flush() again") from self._error
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"write-back flush: {self._rows} rows still "
                        f"pending after {timeout}s")
                self._cv.wait(timeout=0.2)

    def restart(self):
        """(Re)start the worker thread. After a chaos kill the requeued
        batches resume pushing; any wire-level retry of an already-sent
        push is absorbed by the server's request-id dedup."""
        old = self._thread
        if old is not None and old.is_alive():
            if self._error is None and not self._stop:
                return  # healthy worker running, nothing to do
            # the worker set _error (unwinding through the excepthook)
            # or saw stop() and is draining — wait it out so the new
            # thread can't race it
            old.join(timeout=30)
        with self._cv:
            self._error = None
            self._stop = False  # a stop()ed queue restarts cleanly too
            self._cv.notify_all()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hbm-cache-writeback")
        self._thread.start()

    def stop(self, flush=True):
        if flush and self._error is None:
            self.flush()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -- worker side -------------------------------------------------------
    def _take_batch(self):
        with self._cv:
            while not self._items and not self._stop:
                self._cv.wait(timeout=0.2)
            if not self._items:
                return None  # stopped and drained
            items, self._items = self._items, []
            self._inflight = items
            return items

    def _run(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            merged = self._coalesce(batch)
            try:
                # chaos seam: fires BEFORE anything hits the wire, so a
                # killed worker leaves `batch` fully requeued below —
                # deltas are never lost, only delayed until restart()
                _faults.kill_point("ps/writeback")
                for table, keys, deltas in merged:
                    self.client.push_sparse_delta(table, keys, deltas)
            except BaseException:
                with self._cv:
                    self._items = batch + self._items
                    self._inflight = []
                    self._error = sys.exc_info()[1]
                    self._cv.notify_all()
                raise  # unhandled → threading excepthook → flight dump
            with self._cv:
                n = sum(int(k.size) for _t, k, _d in batch)
                self._rows -= n
                self.pushed_rows += n
                self._inflight = []
                self._cv.notify_all()

    def _coalesce(self, items):
        """Merge the taken batches per table (duplicate keys sum — the
        server's delta composition rule), then split each table's sorted
        key set at key-range boundaries (``key >> range_bits``), capping
        chunks at ``max_rows_per_push`` — one bounded, contiguous-range
        wire push per chunk."""
        by_table = {}
        for table, keys, deltas in items:
            by_table.setdefault(table, []).append((keys, deltas))
        out = []
        for table, kds in by_table.items():
            keys = np.concatenate([k for k, _d in kds])
            deltas = np.concatenate(
                [d.reshape(k.size, -1) for k, d in kds])
            uniq, inv = np.unique(keys, return_inverse=True)
            merged = np.zeros((uniq.size, deltas.shape[1]), np.float32)
            np.add.at(merged, inv, deltas)
            self.coalesced_rows += int(keys.size - uniq.size)
            monitor.stat_add("hbm_writeback_coalesced_rows",
                             int(keys.size - uniq.size))
            ranges = (uniq >> np.uint64(self.range_bits)).astype(np.uint64)
            start = 0
            for i in range(1, uniq.size + 1):
                full = (i - start) >= self.max_rows_per_push
                boundary = i == uniq.size or ranges[i] != ranges[start]
                if full or boundary:
                    out.append((table, uniq[start:i], merged[start:i]))
                    start = i
        return out
