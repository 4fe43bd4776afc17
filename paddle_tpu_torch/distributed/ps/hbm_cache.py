"""Device-resident embedding cache + pass-level trainer — the GPUPS analog
(counterpart: ``paddle_tpu/distributed/ps/hbm_cache.py``; the reference
framework's `framework/fleet/ps_gpu_wrapper.cc:43/533` BuildTask /
BuildGPUPSTask, `framework/fleet/heter_ps/hashtable.h` device hash
tables, `framework/trainer.h:250` PSGPUTrainer). The names keep the
reference's "HBM": on the H100 the table lives in the card's HBM3.

Before a pass, every key the pass touches is deduplicated and bulk-pulled
from the parameter servers into a device-resident table; lookups and
optimizer updates then run on the device, and the end of the pass writes
the trained rows back.

The design on the card:

- The table is a ``(capacity, dim)`` float32 tensor on the card, with
  ``staged`` (the rows as pulled, the write-back baseline) beside it and,
  for Adam, ``m``, ``v`` and the per-row step ``t``. All of them are
  allocated once and updated in place (``index_select``, ``index_copy_``,
  ``index_add_``): a captured CUDA graph keeps reading the same addresses.
- Key -> slot lookup is a host-side LRU ``OrderedDict`` with a free list, a
  dirty mask, plan pins and the pending installs, evictions and moves, all
  numpy, as in the reference. Row 0 is a scratch slot that absorbs the
  padded lanes of power-of-two buckets (a bounded set of device shapes).
- Misses are pulled in batches, cold rows are LRU-evicted with a delta
  write-back, so a capacity smaller than the working set degrades instead
  of failing.
- The optimizer (SGD or Adam) follows ``ps_service.cc``'s server rules,
  in float32 with the same constants (``kOptAdam``:
  ``p -= lr * (m/bc1) / (sqrt(v/bc2) + eps)``, ``t`` per row).
- Rows pulled by the prefetch thread stay on the host until the consumer
  thread installs them (:meth:`HbmEmbeddingCache._flush_installs`): the
  prefetcher never touches a device tensor. Installs copy through pinned
  host buffers (asynchronous on the card's current stream), each kept
  until an event recorded after its copy has completed.

The k-step window (``to_static(..., scan_steps=k)``): the lookup inside the
body is :meth:`HbmEmbeddingCache.scan_lookup`, an autograd Function whose
forward gathers ``table[slots][inv]`` and whose backward ``index_add_``\\ s
the rows' gradient into a delta store preallocated once per cache (the
reference's carried table gradient). :meth:`drain_window` applies the
optimizer to the touched rows from that store once per window and zeroes
it in place; it is never rebound, so a captured graph accumulates into a
live address on every replay.

Write-back pushes ``trained - staged`` deltas (kPushSparseDelta), so the
server composes concurrent workers' contributions the same way geo mode
does; with one worker the final server rows equal the device rows
exactly.

Cache observability rides the global monitor registry (monitor.py):
``hbm_cache_hit`` / ``hbm_cache_miss`` / ``hbm_cache_evict`` /
``hbm_cache_writeback_rows``. Eviction has the reference's
telemetry-driven adaptive watermark (``free_target`` / ``evict_ahead``).

Row sharding (``mesh=``, ``mesh_axis=``): the reference places one global
table on the devices of one process; here a mesh axis is ranks, each
driving its own device. Every rank of the axis sees the same batches and
runs the same planner, so the host index (slots, LRU order, free list) is
the same on every rank. Rank ``r`` holds the ``capacity / n`` rows of its
block ``[r * capacity / n, (r + 1) * capacity / n)`` of the slot space. A
lookup gathers the rows it owns, zeroes the others and sums over the
axis's group (exact: every other term is zero); each rank updates,
installs, pulls, evicts and writes back only its own rows, so each row is
pushed once. The losses are bitwise those of the unsharded cache. The
planner must run in the same order on every rank: window plans are made
on the consumer thread (a ``CachePrefetcher`` refuses a sharded cache),
and the adaptive watermark is agreed over the group (its largest value).
"""
import time
from collections import OrderedDict

import numpy as np
import torch

from ... import _lockwatch as lockwatch
from ... import monitor
from ...core.device import resolve_device
from ...core.tensor import unwrap
from .embedding import SparseEmbedding, host_array

__all__ = ["HbmEmbeddingCache", "CachedSparseEmbedding", "PsTpuTrainer"]


def _bucket(n):
    b = 8
    while b < n:
        b <<= 1
    return b


def _f32(x):
    """``x`` rounded to float32 (as a Python float, exact): the constants
    of the rules are float32 scalars, as on the server."""
    return float(np.float32(x))


def _padded(slots, width=None):
    """int32 ``slots`` padded with scratch row 0 to a power-of-two bucket
    (or ``width``)."""
    n = slots.size
    out = np.zeros(_bucket(n) if width is None else width, np.int32)
    out[:n] = slots
    return out


class _ScanLookup(torch.autograd.Function):
    """``table[slots][inv]`` whose gradient goes to the cache's delta
    store (``index_add_`` into its rows) and to no input. ``anchor`` is a
    leaf that requires grad, so the backward runs."""

    @staticmethod
    def forward(ctx, anchor, cache, slots, inv):
        ctx.cache = cache
        ctx.save_for_backward(slots, inv)
        rows = cache._gather(cache.table, slots)
        return rows.index_select(0, inv.reshape(-1)).reshape(
            *inv.shape, cache.dim)

    @staticmethod
    def backward(ctx, grad):
        slots, inv = ctx.saved_tensors
        cache = ctx.cache
        delta = cache.delta
        g = grad.reshape(-1, delta.shape[1]).to(delta.dtype)
        rows = torch.zeros((slots.shape[0], delta.shape[1]),
                           dtype=delta.dtype, device=delta.device)
        rows.index_add_(0, inv.reshape(-1), g)
        cache._add(delta, slots, rows)
        return None, None, None, None


class HbmEmbeddingCache:
    """Device-resident cache over one PS sparse table, on ``device`` (the
    card unless ``"cpu"``).

    ``capacity`` counts device rows; row 0 is reserved as the padding
    scratch slot, so ``capacity - 1`` keys can be resident. With ``mesh``
    and ``mesh_axis`` the rows are sharded over the axis's ranks (the
    module's docstring): each rank holds ``capacity / n`` of them.
    """

    def __init__(self, client, table_id, dim, capacity, optimizer="sgd",
                 lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8, mesh=None,
                 mesh_axis=None, writeback=None, watermark=(0.0, 0.15),
                 pull_chunk=1 << 16, device=None):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (row 0 is scratch)")
        self._sharded, self._group = False, None  # the mesh axis's group
        self._lo, self._rows = 0, capacity
        if mesh is not None and mesh_axis is not None:
            from .. import parallel_env
            group = parallel_env.axis_group(mesh, mesh_axis)
            n = parallel_env.axis_degree(mesh, mesh_axis)
            if capacity % n:
                raise ValueError(
                    f"capacity {capacity} must divide the mesh axis "
                    f"{mesh_axis!r} ({n} devices)")
            self._sharded, self._group = True, group
            self._rows = capacity // n
            self._lo = parallel_env.axis_rank(mesh, mesh_axis) * self._rows
        if optimizer not in ("sgd", "adam"):
            raise ValueError(f"unsupported cache optimizer {optimizer!r}")
        self.client = client
        self.table_id = table_id
        self.dim = dim
        self.capacity = capacity
        self.optimizer = optimizer
        self.lr = _f32(lr)
        self.beta1, self.beta2, self.eps = _f32(beta1), _f32(beta2), \
            _f32(eps)
        self.device = resolve_device(device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)

        rows = self._rows  # this rank's block (all of them unsharded)
        self._table = zeros(rows, dim)
        self.staged = zeros(rows, dim)
        if optimizer == "adam":
            self.m = zeros(rows, dim)
            self.v = zeros(rows, dim)
            self.t = zeros(rows)
        # the window delta store that scan_lookup's backward accumulates
        # into: made here, on the constructing thread and its stream, so
        # that no planner thread ever allocates or fills a device tensor
        self.delta = zeros(rows, dim)
        self._anchor = torch.zeros((), device=self.device,
                                   requires_grad=True)
        self._fused_progs = {}        # (fn, shapes) -> program
        self._slots = OrderedDict()   # key -> slot, LRU order (front=cold)
        self._free = list(range(capacity - 1, 0, -1))  # never slot 0
        self._key_of = np.zeros(capacity, np.uint64)
        self._dirty = np.zeros(capacity, bool)
        self._pending = []            # (slots, slots_p, slice) per lookup
        # one re-entrant lock serializes the host index structures between
        # the foreground step and the prefetch/write-back threads
        self._mu = lockwatch.RLock(name="hbm_cache.mu")
        self.writeback = writeback    # optional WriteBackQueue
        self._plan_pins = {}          # key -> count of unconsumed plans
        # deferred device work from the prefetch stage (installed on the
        # consumer thread by _flush_installs)
        self._pending_install = []        # [(slots int32, rows f32)]
        self._pending_install_slots = set()
        self._pending_evict = []          # [(dirty victim slots, keys)]
        self._pending_copy = []           # [(src slots, dst slots)]
        self._staging = []                # [(event, pinned buffer)]
        self.watermark_min_frac, self.watermark_max_frac = watermark
        self.pull_chunk = int(pull_chunk)
        self._pull_ms_ema = None
        self._hit_ema = 0.0
        self._miss_ema = 0.0

    @property
    def table(self):
        """The device table, ``(capacity, dim)`` float32 (this rank's
        ``(capacity / n, dim)`` block when sharded): one tensor for the
        cache's life, updated in place (never rebound)."""
        return self._table

    @property
    def sharded(self):
        return self._sharded

    # -- this rank's rows (all of them unsharded) -------------------------
    def _owned(self, slots):
        """Host slots: the mask of those this rank holds, and their
        indices in its block."""
        slots = np.asarray(slots, np.int64)
        return ((slots >= self._lo) & (slots < self._lo + self._rows),
                slots - self._lo)

    def _local(self, sj):
        """Device slots ``sj``: their indices in this rank's block (0 for
        the others) and the mask of those it holds."""
        own = (sj >= self._lo) & (sj < self._lo + self._rows)
        return torch.where(own, sj - self._lo, torch.zeros_like(sj)), own

    @staticmethod
    def _lanes(mask, vals):
        return mask.view(-1, *([1] * (vals.dim() - 1)))

    def _gather(self, t, sj):
        """Rows ``sj`` of ``t`` on every rank: sharded, each rank's own
        rows with the others zeroed, summed over the axis's group."""
        if not self.sharded:
            return t.index_select(0, sj)
        from .. import collective
        loc, own = self._local(sj)
        rows = t.index_select(0, loc)
        rows = torch.where(self._lanes(own, rows), rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        return collective.all_reduce(rows, group=self._group)

    def _take(self, t, sj):
        """Rows ``sj`` of ``t`` where this rank holds them (sharded, the
        other lanes read an arbitrary row: only writes masked to this
        rank's lanes may use them)."""
        if not self.sharded:
            return t.index_select(0, sj)
        return t.index_select(0, self._local(sj)[0])

    def _add(self, t, sj, vals):
        """``t[sj] += vals`` for the rows this rank holds."""
        if not self.sharded:
            t.index_add_(0, sj, vals)
            return
        loc, own = self._local(sj)
        t.index_add_(0, loc, torch.where(
            self._lanes(own, vals), vals,
            torch.zeros((), dtype=vals.dtype, device=vals.device)))

    def _copy(self, t, sj, vals):
        """``t[sj] = vals`` for the rows this rank holds. Sharded, the
        other lanes repeat an owned lane's write (one target, one value,
        so the duplicates cannot race); with no owned lane, every lane
        writes row 0 of the block its own value. Static shapes, no host
        read: legal under capture."""
        if not self.sharded:
            t.index_copy_(0, sj, vals)
            return
        if sj.numel() == 0:
            return
        loc, own = self._local(sj)
        lane = torch.arange(sj.shape[0], device=sj.device)
        donor = torch.where(own, lane, torch.full_like(lane, -1)).amax()
        src = torch.where(own, lane, donor.clamp(min=0))
        dst = loc.index_select(0, src)
        out = torch.where(donor >= 0, vals.index_select(0, src),
                          t.index_select(0, dst))
        t.index_copy_(0, dst, out)

    def _agree(self, n):
        """The largest of the ranks' ``n`` (sharded; ``n`` itself
        unsharded): decisions the planner takes from timings must be the
        same on every rank."""
        if not self.sharded:
            return n
        from .. import collective
        v = torch.tensor([int(n)], dtype=torch.int64, device=self.device)
        collective.all_reduce(v, op=collective.ReduceOp.MAX,
                              group=self._group)
        return int(v.item())

    # -- host -> device ---------------------------------------------------
    def _to_device(self, arr):
        """A host array as a tensor on the cache's device. On the card the
        copy goes through a pinned buffer, asynchronously on the current
        stream; the buffer is kept until an event recorded after the copy
        has completed."""
        arr = np.ascontiguousarray(arr)
        if self.device.type == "cpu":
            return torch.from_numpy(arr.copy())
        self._staging = [(ev, buf) for ev, buf in self._staging
                         if not ev.query()]
        buf = torch.from_numpy(arr).pin_memory()
        out = buf.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._staging.append((ev, buf))
        return out

    def _slots_tensor(self, slots):
        return self._to_device(slots.astype(np.int64))

    def _to_host(self, t):
        return t.detach().cpu().numpy()

    # -- the device rules (ps_service.cc's server rules) ------------------
    def _install(self, slots_p, rows_p):
        """Rows ``rows_p`` (host) into slots ``slots_p``, the ones this
        rank holds."""
        own, loc = self._owned(slots_p)
        if not own.any():
            return
        if not own.all():
            rows_p = rows_p[own]
        sj = self._slots_tensor(loc[own])
        rj = self._to_device(rows_p)
        self.table.index_copy_(0, sj, rj)
        self.staged.index_copy_(0, sj, rj)

    def _write_back(self, slots, keys):
        """Push ``trained - staged`` of the rows ``slots`` (keys ``keys``)
        that this rank holds."""
        own, loc = self._owned(slots)
        if not own.any():
            return
        sj = self._slots_tensor(loc[own])
        delta = self.table.index_select(0, sj) - self.staged.index_select(
            0, sj)
        self._push_delta(np.asarray(keys)[own], self._to_host(delta))

    def _pull_rows(self, keys, slots, chunk=None):
        """The server's rows of ``keys`` bound for ``slots``: pulled for
        the slots this rank holds, zeros for the others."""
        own, _ = self._owned(slots)
        rows = np.zeros((keys.size, self.dim), np.float32)
        want = keys[own]
        if want.size:
            step = chunk or want.size
            rows[own] = np.concatenate(
                [self.client.pull_sparse(self.table_id, want[i:i + step])
                 for i in range(0, want.size, step)])
        return rows

    def _update(self, sj, g):
        """The optimizer on rows ``sj`` (int64, on the device; padded lanes
        at scratch row 0, with zero gradient) with gradient ``g``."""
        if self.optimizer == "sgd":
            self._add(self.table, sj, g * -self.lr)
            return
        b1, b2 = self.beta1, self.beta2
        self._add(self.t, sj, torch.ones_like(sj, dtype=torch.float32))
        ts = self._take(self.t, sj)[:, None]
        c1, c2 = (_f32(np.float32(1) - np.float32(b)) for b in (b1, b2))
        mn = self._take(self.m, sj) * b1 + g * c1
        vn = self._take(self.v, sj) * b2 + g * c2 * g
        self._copy(self.m, sj, mn)
        self._copy(self.v, sj, vn)
        bc1 = 1.0 - torch.pow(b1, ts)
        bc2 = 1.0 - torch.pow(b2, ts)
        self._add(self.table, sj,
                  (mn / bc1) * -self.lr / (torch.sqrt(vn / bc2) + self.eps))

    # -- vectorized residency ---------------------------------------------
    @staticmethod
    def _member(sorted_keys, keys):
        """Membership of ``keys`` in sorted ``sorted_keys``; returns
        ``(mask, pos)`` with ``sorted_keys[pos] == keys`` where mask
        holds."""
        pos = np.searchsorted(sorted_keys, keys)
        if not sorted_keys.size:
            return np.zeros(keys.size, bool), pos
        mask = (pos < sorted_keys.size) & (
            sorted_keys[np.minimum(pos, sorted_keys.size - 1)] == keys)
        return mask, pos

    def _resident_mask(self, keys):
        res = np.sort(np.fromiter(self._slots.keys(), np.uint64,
                                  len(self._slots)))
        return self._member(res, keys)[0]

    def _resident_index(self):
        """Aligned ``(keys, slots)`` snapshot of the resident index,
        sorted by key."""
        n = len(self._slots)
        keys = np.fromiter(self._slots.keys(), np.uint64, n)
        slots = np.fromiter(self._slots.values(), np.int32, n)
        order = np.argsort(keys)
        return keys[order], slots[order]

    # -- pass staging (BuildGPUPSTask analog) -----------------------------
    def build_pass(self, keys):
        """Dedup ``keys`` (every feasign in the upcoming pass), bulk-pull
        the non-resident ones from the PS, and stage them on the device.
        If the pass working set exceeds capacity, the most frequent keys
        are staged and the tail is left to per-batch faulting."""
        keys = host_array(keys, np.uint64).ravel()
        uniq, counts = np.unique(keys, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        uniq = uniq[order]
        with self._mu:
            self._flush_installs()
            return self._build_pass_locked(uniq)

    def _build_pass_locked(self, uniq):
        resident = self._resident_mask(uniq)
        missing = uniq[~resident]
        # LRU-refresh already-resident keys of this pass, coldest first
        for key in uniq[resident][::-1]:
            self._slots.move_to_end(int(key))
        room = len(self._free)
        if missing.size > room:
            missing = missing[:room]
        # install least-frequent-FIRST so the hottest keys end up most
        # recently used
        missing = missing[::-1].copy()
        if missing.size:
            self._fault_in(missing, count_miss=False)
        monitor.stat_add("hbm_cache_staged", int(missing.size))
        return int(missing.size)

    # -- lookup (differentiable; PullSparse analog) -----------------------
    def lookup(self, ids):
        """Differentiable embedding lookup served from the device table.
        Returns a tensor shaped ``ids.shape + (dim,)``; the gathered slice
        is recorded so :meth:`apply_grads` can run the device optimizer
        after ``loss.backward()``. The slice is bucket-padded (padded
        lanes read scratch row 0)."""
        ids_np = host_array(ids, np.int64)
        shape = ids_np.shape
        uniq, inv = np.unique(ids_np.ravel(), return_inverse=True)
        grad = torch.is_grad_enabled()
        with self._mu:
            self._flush_installs()  # prefetched rows become readable
            slots = self._ensure(uniq.astype(np.uint64))
            slots_p = _padded(slots)
            rows_p = self._gather(self.table, self._slots_tensor(slots_p))
            slice_t = rows_p.detach().requires_grad_(grad)
            if grad:
                self._pending.append((slots, slots_p, slice_t))
        inv_t = self._to_device(inv.reshape(-1).astype(np.int64))
        return slice_t.index_select(0, inv_t).reshape(*shape, self.dim)

    # -- optimizer update (PushSparseGrad + optimizer.cuh.h analog) -------
    def apply_grads(self):
        """Apply every recorded slice gradient to the device table with
        the cache's optimizer rule. Call after ``loss.backward()``."""
        with self._mu:
            self._flush_installs()
            self._apply_pending()

    def _apply_pending(self):
        for slots, slots_p, slice_t in self._pending:
            if slice_t.grad is None:
                continue
            # the slice grad is bucket-padded; padded rows are zero and
            # target scratch
            self._update(self._slots_tensor(slots_p),
                         slice_t.grad.to(torch.float32))
            self._dirty[slots] = True
            self._dirty[0] = False  # scratch row never written back
        self._pending = []

    # -- fused pass ---------------------------------------------------------
    def _fused_feeds(self, ids_batches, labels):
        """The pass's static-shaped ``(slots [K, b], inv [K, ...], labels
        [K, ...])`` host feeds, resolved against one sorted snapshot of
        the resident index; every key must be resident."""
        self._flush_installs()
        shape = host_array(ids_batches[0]).shape
        if not self._slots:
            raise RuntimeError("fused pass requires every key staged "
                               "(build_pass first); cache is empty")
        res_keys, res_slots = self._resident_index()
        slots_l, inv_l = [], []
        for ids in ids_batches:
            ids_np = host_array(ids, np.int64)
            if ids_np.shape != shape:
                raise ValueError("all fused-pass batches must share one "
                                 "shape (one captured program)")
            uniq, inv = np.unique(ids_np.ravel(), return_inverse=True)
            uniq = uniq.astype(np.uint64)
            ok, pos = self._member(res_keys, uniq)
            if not ok.all():
                raise RuntimeError(
                    f"fused pass requires every key staged "
                    f"(build_pass first); key {int(uniq[~ok][0])} is not "
                    f"resident")
            slots_l.append(res_slots[pos])
            inv_l.append(inv.reshape(shape).astype(np.int64))
        monitor.stat_add("hbm_cache_hit",
                         int(sum(s.size for s in slots_l)))
        b = _bucket(max(s.size for s in slots_l))
        slots_a = np.stack([_padded(s, b) for s in slots_l])
        lab_a = (np.stack([host_array(l, np.float32) for l in labels])
                 if labels is not None
                 else np.zeros((len(ids_batches), 1), np.float32))
        return shape, slots_a, np.stack(inv_l), lab_a, slots_l

    def _fused_body(self, emb_loss_fn, shape, has_labels):
        """One batch of the fused pass: gather, ``emb_loss_fn`` forward and
        backward, the optimizer on the batch's rows; returns the loss."""
        dim = self.dim

        def body(slots_k, inv_k, lab_k):
            with torch.enable_grad():
                rows = self._gather(self.table, slots_k).requires_grad_()
                e = rows.index_select(0, inv_k.reshape(-1)).reshape(
                    *shape, dim)
                loss = emb_loss_fn(e, lab_k) if has_labels \
                    else emb_loss_fn(e)
                (dr,) = torch.autograd.grad(loss, rows)
            with torch.no_grad():
                self._update(slots_k, dr)
            return loss.detach()

        return body

    def run_fused_pass(self, ids_batches, emb_loss_fn, labels=None):
        """Run a whole staged pass as ONE program: the reference's
        ``lax.scan`` over batches is ``to_static(body, scan_steps=K)``, on
        the card one CUDA graph of one batch replayed K times.

        ``ids_batches``: list of int id arrays, all the same shape.
        ``emb_loss_fn(emb[, label]) -> scalar`` is a torch function and a
        stable callable — the program is cached on its identity (at most
        16 programs are kept). ``labels``: optional per-batch arrays.
        Every key must be resident (the pass contract); a miss raises.
        Returns the per-batch losses as a numpy array."""
        return self._fused_pass(ids_batches, emb_loss_fn, labels)

    def _fused_pass(self, ids_batches, emb_loss_fn, labels, program=True):
        """:meth:`run_fused_pass`; ``program=False`` runs the same body
        eagerly, batch by batch (the program's check)."""
        from ...jit.to_static import to_static

        with self._mu:
            shape, slots_a, inv_a, lab_a, slots_l = self._fused_feeds(
                ids_batches, labels)
            K, b = slots_a.shape
            has_labels = labels is not None
            body = self._fused_body(emb_loss_fn, shape, has_labels)
            feeds = (self._to_device(slots_a.astype(np.int64)),
                     self._to_device(inv_a), self._to_device(lab_a))
            if program:
                key = (emb_loss_fn, shape, K, b, has_labels, lab_a.shape)
                run = self._fused_progs.get(key)
                if run is None:
                    if len(self._fused_progs) >= 16:  # bound kept programs
                        self._fused_progs.pop(next(iter(self._fused_progs)))
                    run = self._fused_progs[key] = to_static(
                        body, scan_steps=K)
                losses = run(*feeds)
            else:
                losses = torch.stack([body(*(f[i] for f in feeds))
                                      for i in range(K)])
            touched = np.unique(np.concatenate(slots_l))
            self._dirty[touched] = True
            self._dirty[0] = False
        return self._to_host(losses)

    # -- write-back (EndPass analog) --------------------------------------
    def end_pass(self, flush=True):
        """Push ``trained - staged`` deltas for every dirty resident row
        back to the PS and re-baseline. Rows stay resident for the next
        pass (warm cache across passes). With a write-back queue the
        deltas enqueue to it, and ``flush=True`` drains it so the server
        rows equal the device rows at return.

        The server adds each pushed delta to its row, ``staged + (trained
        - staged)`` in float32, which can differ from ``trained`` by one
        rounding; the device rows take that same sum, so with one worker
        the server rows equal the device rows bitwise after the pass."""
        with self._mu:
            self._flush_installs()
            dirty = np.nonzero(self._dirty)[0]
            own, loc = self._owned(dirty)
            if own.any():
                keys = self._key_of[dirty[own]]
                sj = self._slots_tensor(loc[own])
                base = self.staged.index_select(0, sj)
                delta = self.table.index_select(0, sj) - base
                self._push_delta(keys, self._to_host(delta))
                self.table.index_copy_(0, sj, base + delta)
                self.staged.copy_(self.table)  # re-baseline on device
            self._dirty[:] = False
            monitor.stat_add("hbm_cache_writeback_rows", int(own.sum()))
        if flush and self.writeback is not None:
            self.writeback.flush()
        return int(dirty.size)

    # -- the k-step window (to_static(..., scan_steps=k)) -----------------
    def enable_scan_feeds(self):
        """The window delta store (``(capacity, dim)`` float32) that
        :meth:`scan_lookup`'s backward accumulates into. It is made with
        the cache and lives as long as it, zeroed in place by
        :meth:`drain_window` and never rebound."""
        return self.delta

    def scan_lookup(self, slots, inv):
        """Differentiable lookup by prebuilt static-shaped feeds (from a
        :class:`~.async_cache.WindowPlan`): ``table[slots][inv]``, legal
        inside a ``to_static(..., scan_steps=k)`` body. The gradient
        ``index_add_``\\ s into the delta store; call :meth:`drain_window`
        after the window."""
        return _ScanLookup.apply(self._anchor, self, unwrap(slots).long(),
                                 unwrap(inv).long())

    def plan_window(self, ids, bucket=None):
        """Host half of a scan window's lookups: dedupe the ``[k, ...]``
        id block per inner step, fault every missing key in (batched,
        chunked, riding the client retry policy) and build the
        static-shaped ``(slots, inv)`` feeds. The window's keys are
        PINNED against eviction until the plan is consumed. Runs on the
        prefetcher thread in the async pipeline; it never touches a device
        tensor: pulled rows stage on the host until
        :meth:`_flush_installs` installs them on the consumer thread.

        ``bucket`` pins the slot-feed width W (a power of two >= the max
        per-step unique count) so every window of a run shares ONE
        program; default: the smallest bucket for this window.
        """
        from .async_cache import WindowPlan

        t0 = time.perf_counter()
        ids_np = host_array(ids, np.int64)
        if ids_np.ndim < 2:
            raise ValueError(
                f"plan_window expects [k, ...]-stacked ids; got shape "
                f"{ids_np.shape}")
        k = ids_np.shape[0]
        uniq_l, inv_l = [], []
        for i in range(k):
            u, inv = np.unique(ids_np[i].ravel(), return_inverse=True)
            uniq_l.append(u.astype(np.uint64))
            inv_l.append(inv.astype(np.int32))
        wmax = max(u.size for u in uniq_l)
        W = _bucket(wmax) if bucket is None else int(bucket)
        if W < wmax:
            raise ValueError(
                f"bucket {W} < max per-step unique count {wmax}")
        all_keys = np.unique(np.concatenate(uniq_l))
        window_pin = set(int(x) for x in all_keys)
        slots_a = np.zeros((k, W), np.int32)
        with self._mu:
            # window-level dedupe: classify every key once, allocate slots
            # for the misses (evictions deferred: no device reads on this
            # thread), then resolve the per-step feeds
            resident = self._resident_mask(all_keys)
            missing = all_keys[~resident].tolist()
            hits = sum(u.size for u in uniq_l) - len(missing)
            monitor.stat_add("hbm_cache_hit", hits)
            monitor.stat_add("hbm_cache_miss", len(missing))
            self._hit_ema = 0.98 * self._hit_ema + hits
            self._miss_ema = 0.98 * self._miss_ema + len(missing)
            # resurrection: a missed key whose deferred-evict delta has not
            # flushed yet still has its rows intact on the device —
            # relocate them instead of re-pulling a stale value
            resurrect = {}
            if missing and self._pending_evict:
                pe = {}
                for ei, (_dv, ks) in enumerate(self._pending_evict):
                    for j, kk in enumerate(ks.tolist()):
                        pe[int(kk)] = (ei, j)
                still = []
                for kk in missing:
                    if int(kk) in pe:
                        resurrect[int(kk)] = pe[int(kk)]
                    else:
                        still.append(kk)
                missing = still
                monitor.stat_add("hbm_cache_resurrect", len(resurrect))
            miss_keys = np.asarray(missing, np.uint64)
            n_new = miss_keys.size + len(resurrect)
            if n_new:
                need = n_new - len(self._free)
                if need > 0:
                    self._evict(need, window_pin, defer=True)
                if n_new > len(self._free):
                    raise RuntimeError(
                        f"hbm cache over capacity: window needs "
                        f"{n_new} new slots, {len(self._free)} "
                        f"free after eviction (window working set larger "
                        f"than capacity {self.capacity}?)")
            if resurrect:
                drop = {}
                src_l, dst_l = [], []
                for kk, (ei, j) in resurrect.items():
                    dv, _ks = self._pending_evict[ei]
                    s_new = int(self._free.pop())
                    src_l.append(int(dv[j]))
                    dst_l.append(s_new)
                    self._slots[kk] = s_new
                    self._key_of[s_new] = kk
                    self._dirty[s_new] = True   # delta still local
                    self._pending_install_slots.add(s_new)
                    drop.setdefault(ei, []).append(j)
                self._pending_copy.append(
                    (np.asarray(src_l, np.int32),
                     np.asarray(dst_l, np.int32)))
                keep = []
                for ei, (dv, ks) in enumerate(self._pending_evict):
                    if ei in drop:
                        m = np.ones(len(ks), bool)
                        m[drop[ei]] = False
                        dv, ks = dv[m], ks[m]
                    if len(ks):
                        keep.append((dv, ks))
                self._pending_evict = keep
            if miss_keys.size:
                miss_slots = np.array(
                    [self._free.pop() for _ in range(miss_keys.size)],
                    np.int32)
                for kk, s in zip(miss_keys.tolist(), miss_slots.tolist()):
                    self._slots[int(kk)] = int(s)
                    self._key_of[s] = kk
                    self._pending_install_slots.add(int(s))
            slot_of = np.fromiter(
                (self._slots[int(kk)] for kk in all_keys.tolist()),
                np.int32, all_keys.size)
            for i, u in enumerate(uniq_l):
                idx = np.searchsorted(all_keys, u)
                slots_a[i, :u.size] = slot_of[idx]
            for kk in all_keys.tolist():
                self._slots.move_to_end(int(kk))
            for kk in window_pin:
                self._plan_pins[kk] = self._plan_pins.get(kk, 0) + 1
        pull_s = 0.0
        if miss_keys.size:
            # read-your-writes: deltas still queued for a re-faulted key
            # must land before the pull
            if self.writeback is not None and \
                    self.writeback.has_pending(self.table_id, miss_keys):
                self.writeback.flush()
            tp = time.perf_counter()
            rows = self._pull_rows(miss_keys, miss_slots, self.pull_chunk)
            pull_s = time.perf_counter() - tp
            pull_ms = pull_s * 1e3 / max(
                1, -(-miss_keys.size // self.pull_chunk))
            self._pull_ms_ema = pull_ms if self._pull_ms_ema is None \
                else 0.7 * self._pull_ms_ema + 0.3 * pull_ms
            with self._mu:
                self._pending_install.append((miss_slots, rows))
        touched = np.unique(slots_a)
        touched = touched[touched != 0].astype(np.int32)
        inv_a = np.stack(inv_l).reshape((k,) + ids_np.shape[1:])
        return WindowPlan(self, slots_a, inv_a, touched, all_keys,
                          plan_s=time.perf_counter() - t0, pull_s=pull_s)

    def _release_pins(self, keys):
        with self._mu:
            for kk in np.asarray(keys, np.uint64).ravel().tolist():
                kk = int(kk)
                c = self._plan_pins.get(kk)
                if c is not None:
                    if c <= 1:
                        del self._plan_pins[kk]
                    else:
                        self._plan_pins[kk] = c - 1

    def drain_window(self, plan=None):
        """Consume the delta store a window accumulated: apply the cache
        optimizer to the touched rows with the window-summed gradient (one
        update per row per window), zero the store in place, mark the rows
        dirty, release the plan's pins and run :meth:`evict_ahead`.
        Returns the touched row count. Without ``plan`` the touched set
        is recovered from the store's nonzero rows (a host read — pass the
        plan)."""
        with self._mu:
            self._flush_installs()
            if plan is not None:
                touched = plan.touched_slots
            else:  # this rank's rows whose store is nonzero
                nz = np.nonzero(self._to_host(
                    (self.delta != 0.0).any(dim=1)))[0] + self._lo
                touched = nz[nz != 0].astype(np.int32)
            n = int(touched.size)
            if n:
                sj = self._slots_tensor(_padded(touched))
                # padded lanes read scratch row 0, whose store is zero
                self._update(sj, self._take(self.delta, sj))
                self._dirty[touched] = True
                self._dirty[0] = False  # scratch row never written back
            self.delta.zero_()
            monitor.stat_add("hbm_cache_window_rows", n)
        if plan is not None:
            plan.release()
        self.evict_ahead()
        return n

    @property
    def stats(self):
        return {k: monitor.stat_get(f"hbm_cache_{k}")
                for k in ("hit", "miss", "evict", "staged",
                          "writeback_rows")}

    # -- internals --------------------------------------------------------
    def _ensure(self, uniq_keys, pinned=None):
        """Map unique keys to device slots, faulting misses in (batched)
        and LRU-evicting if full. Returns int32 slots. Caller holds _mu."""
        slots = np.empty(uniq_keys.size, np.int32)
        misses = []
        for i, k in enumerate(uniq_keys):
            k = int(k)
            s = self._slots.get(k)
            if s is None:
                misses.append(i)
                slots[i] = -1
            else:
                self._slots.move_to_end(k)
                slots[i] = s
        hits = uniq_keys.size - len(misses)
        monitor.stat_add("hbm_cache_hit", hits)
        self._hit_ema = 0.98 * self._hit_ema + hits
        self._miss_ema = 0.98 * self._miss_ema + len(misses)
        if misses:
            missed = uniq_keys[misses]
            pin = set(uniq_keys.tolist()) | (pinned or set())
            got = self._fault_in(missed, pinned=pin)
            slots[misses] = got
        return slots

    def _fault_in(self, keys, pinned=None, count_miss=True):
        """Pull ``keys`` from the PS and install them, evicting LRU victims
        (with delta write-back) when the free list runs dry; chunked by
        ``pull_chunk``. Caller holds _mu."""
        if keys.size > self.pull_chunk:
            return np.concatenate(
                [self._fault_in(keys[i:i + self.pull_chunk], pinned,
                                count_miss)
                 for i in range(0, keys.size, self.pull_chunk)])
        need = keys.size - len(self._free)
        if need > 0:
            self._evict(need, pinned or set())
        if keys.size > len(self._free):
            raise RuntimeError(
                f"hbm cache over capacity: need {keys.size} slots, "
                f"{len(self._free)} free after eviction (batch working "
                f"set larger than capacity {self.capacity}?)")
        if count_miss:  # pass-level staging is counted as 'staged'
            monitor.stat_add("hbm_cache_miss", int(keys.size))
        # read-your-writes across the async write-back
        if self.writeback is not None and \
                self.writeback.has_pending(self.table_id, keys):
            # read-your-writes: the queued delta reaches the PS before
            # the re-pull (the sync path; plan_window pulls unlocked)
            self.writeback.flush()
        # the slots the keys will take (the free list's end), so that a
        # sharded rank pulls only the rows it holds
        slots = np.asarray(self._free[len(self._free) - keys.size:][::-1],
                           np.int32)
        t0 = time.perf_counter()
        # the sync fault-in path holds the cache lock across the pull by
        # design; plan_window is the unlocked path
        rows = self._pull_rows(keys, slots)
        pull_ms = (time.perf_counter() - t0) * 1e3
        self._pull_ms_ema = pull_ms if self._pull_ms_ema is None else \
            0.7 * self._pull_ms_ema + 0.3 * pull_ms
        del self._free[len(self._free) - keys.size:]
        for k, s in zip(keys.tolist(), slots.tolist()):
            self._slots[int(k)] = int(s)
            self._key_of[s] = k
        slots_p = _padded(slots)
        rows_p = np.zeros((slots_p.size, self.dim), np.float32)
        rows_p[:keys.size] = rows
        self._install(slots_p, rows_p)
        return slots

    def _push_delta(self, keys, delta):
        """Route a delta push: through the bounded background queue when
        one is attached, else synchronously."""
        if self.writeback is not None:
            self.writeback.put(self.table_id, keys, delta)
        else:
            self.client.push_sparse_delta(self.table_id, keys, delta)

    def _evict(self, n, pinned, strict=True, defer=False):
        """Free >= n slots from the LRU front, writing dirty victims'
        deltas back first. ``strict=False`` (evict_ahead) frees what it
        can instead of raising. ``defer=True`` (the prefetch thread)
        records the dirty victims instead of reading the device table;
        :meth:`_flush_installs` computes their deltas before any deferred
        install can reuse the slots. Caller holds _mu."""
        # slots with an un-applied gradient must not be reused
        pending_slots = set()
        for slots, _p, _t in self._pending:
            pending_slots.update(int(s) for s in slots)
        # a pending-install slot's device row is not written yet
        pending_slots |= self._pending_install_slots
        victims, vkeys = [], []
        for k in list(self._slots):          # front of the OrderedDict =
            if (k in pinned or k in self._plan_pins       # LRU front
                    or self._slots[k] in pending_slots):
                continue
            victims.append(self._slots[k])
            vkeys.append(k)
            if len(victims) >= n:
                break
        if len(victims) < n and strict:
            # raise BEFORE touching the index
            raise RuntimeError(
                f"hbm cache cannot evict {n} rows: every resident key is "
                f"pinned by the current batch, a planned window, or an "
                f"un-applied gradient (capacity {self.capacity} too small "
                f"for one step's working set)")
        for k in vkeys:
            del self._slots[k]
        if not victims:
            return 0
        victims = np.asarray(victims, np.int32)
        dirty_mask = self._dirty[victims]
        if dirty_mask.any():
            dv = victims[dirty_mask]
            if defer:
                self._pending_evict.append((dv, self._key_of[dv].copy()))
                monitor.stat_add("hbm_cache_deferred_evict", int(dv.size))
            else:
                self._write_back(dv, self._key_of[dv])
            self._dirty[dv] = False
        self._free.extend(int(s) for s in victims)
        monitor.stat_add("hbm_cache_evict", len(victims))
        return len(victims)

    def _flush_installs(self):
        """Apply the prefetch stage's deferred device work on the consumer
        thread: dirty evictions' delta write-backs first (their rows are
        still intact), then the resurrections' moves, then ONE install of
        every staged pulled row. Cheap when nothing is pending."""
        with self._mu:
            if self._pending_evict:
                for dv, keys in self._pending_evict:
                    self._write_back(dv, keys)
                self._pending_evict = []
            if self._pending_copy:
                # one fused move: every gather reads the rows before any
                # scatter lands (a copy's source may be another's
                # destination)
                src = np.concatenate([s for s, _d in self._pending_copy])
                dst = np.concatenate([d for _s, d in self._pending_copy])
                sj = self._slots_tensor(_padded(src))
                dj = self._slots_tensor(_padded(dst))
                rows, base = (self._gather(self.table, sj),
                              self._gather(self.staged, sj))
                self._copy(self.table, dj, rows)
                self._copy(self.staged, dj, base)
                for s in dst.tolist():
                    self._pending_install_slots.discard(int(s))
                self._pending_copy = []
            if self._pending_install:
                slots = np.concatenate(
                    [s for s, _r in self._pending_install])
                rows = np.concatenate(
                    [r for _s, r in self._pending_install])
                slots_p = _padded(slots)
                rows_p = np.zeros((slots_p.size, self.dim), np.float32)
                rows_p[:slots.size] = rows
                self._install(slots_p, rows_p)
                self._pending_install = []
                # only the slots actually installed lose protection
                for s in slots.tolist():
                    self._pending_install_slots.discard(int(s))

    # -- telemetry-driven eviction (adaptive watermark) -------------------
    def _pull_ms(self):
        """Best available estimate of one PS pull's latency: the
        client-side EMA, falling back to the service-side
        ``ps_server_op_ns`` export of an in-process server."""
        if self._pull_ms_ema is not None:
            return self._pull_ms_ema
        try:
            from .server import server_op_stats
            for r in server_op_stats():
                if (r["table"] == self.table_id
                        and r["op"] == "pull_sparse" and r["calls"]):
                    return r["ns"] / r["calls"] / 1e6
        except Exception:
            pass
        return None

    def free_target(self):
        """Adaptive eviction watermark: how many slots to keep FREE, in
        ``[watermark_min_frac, watermark_max_frac] * capacity``, from the
        cache's hit/miss pressure and the PS pull latency."""
        import math

        lo = int(self.watermark_min_frac * self.capacity)
        hi = int(self.watermark_max_frac * self.capacity)
        pull_ms = self._pull_ms()
        seen = self._hit_ema + self._miss_ema
        if pull_ms is None or seen <= 0.0:
            return lo
        # latency weight: <=0.1 ms -> 0; >=10 ms -> 1; log-linear between
        lat = min(1.0, max(0.0,
                           (math.log10(max(pull_ms, 1e-3)) + 1.0) / 2.0))
        miss_rate = self._miss_ema / seen
        pressure = lat * min(1.0, 4.0 * miss_rate)
        return lo + int(round((hi - lo) * pressure))

    def evict_ahead(self):
        """Evict LRU rows down to :meth:`free_target` ahead of demand
        (best-effort). Returns the number of rows freed."""
        with self._mu:
            need = self._agree(self.free_target()) - len(self._free)
            if need <= 0:
                return 0
            return self._evict(need, set(), strict=False)


class CachedSparseEmbedding(SparseEmbedding):
    """Drop-in :class:`SparseEmbedding` whose rows are served from a
    device-resident cache instead of a per-batch PS round-trip.

    Inside a ``to_static(..., scan_steps=k)`` body, feed the layer a
    ``(slots, inv)`` pair from a prefetched
    :class:`~.async_cache.WindowPlan` (``plan.feeds()``) instead of raw
    ids."""

    def __init__(self, size, capacity=None, table_id=None, init_range=0.1,
                 optimizer="sgd", lr=0.01, beta1=0.9, beta2=0.999,
                 eps=1e-8, mesh=None, mesh_axis=None, writeback=None,
                 watermark=(0.0, 0.15), name=None, device=None):
        super().__init__(size, table_id=table_id, init_range=init_range,
                         name=name)
        num, _dim = size
        self.capacity = capacity if capacity is not None else num + 1
        self._cache_cfg = dict(optimizer=optimizer, lr=lr, beta1=beta1,
                               beta2=beta2, eps=eps, mesh=mesh,
                               mesh_axis=mesh_axis, writeback=writeback,
                               watermark=watermark, device=device)
        self.cache = None

    def bind(self, communicator):
        super().bind(communicator)
        self.cache = HbmEmbeddingCache(
            communicator.client, self.table_id, self.embedding_dim,
            self.capacity, **self._cache_cfg)

    def forward(self, ids):
        if self.cache is None:
            raise RuntimeError(
                "CachedSparseEmbedding is not bound — call "
                "fleet.init_worker() (or .bind(communicator)) first")
        if isinstance(ids, (tuple, list)) and len(ids) == 2:
            return self.cache.scan_lookup(*ids)
        from ...jit.to_static import in_tracing
        if in_tracing():
            raise RuntimeError(
                "CachedSparseEmbedding inside a to_static body needs "
                "prebuilt (slots, inv) feeds — plan the window with "
                "HbmEmbeddingCache.plan_window (or a CachePrefetcher) "
                "and pass plan.feeds(), not raw ids")
        return self.cache.lookup(ids)


class PsTpuTrainer:
    """Pass-level trainer driving cached embeddings — the PSGPUTrainer
    analog (reference: `framework/trainer.h:250`, `ps_gpu_worker.cc`).

    Per pass: stage every key the pass will touch (BuildGPUPSTask), run
    the batches with on-device sparse updates, write the trained rows
    back (EndPass). Dense parameters ride the given communicator exactly
    like the Downpour path.
    """

    def __init__(self, model, loss_fn, communicator, keys_fn=None):
        self.model = model
        self.loss_fn = loss_fn
        self.comm = communicator
        self.keys_fn = keys_fn
        self.caches = [sub.cache
                       for sub in model.sublayers(include_self=True)
                       if isinstance(sub, CachedSparseEmbedding)]
        if any(c is None for c in self.caches):
            raise RuntimeError("model has unbound CachedSparseEmbedding "
                               "layers — bind_model() first")

    def train_pass(self, batches):
        """One dataset pass over materialized ``batches``. Returns
        ``{"batches": n, "loss_sum": s, "losses": [...]}``."""
        from .embedding import flush_sparse_grads

        batches = list(batches)
        by_table = {}
        for batch in batches:
            for tid, keys in self._batch_keys(batch).items():
                by_table.setdefault(tid, []).append(
                    host_array(keys, np.uint64).ravel())
        for cache in self.caches:
            keys = by_table.get(cache.table_id)
            if keys:
                cache.build_pass(np.concatenate(keys))
        losses = []
        for batch in batches:
            loss = self.loss_fn(self.model, batch)
            loss.backward()
            for cache in self.caches:
                cache.apply_grads()
            flush_sparse_grads(self.comm)  # plain SparseEmbedding layers
            self.comm.step()
            losses.append(float(host_array(loss)))
        for cache in self.caches:
            cache.end_pass()
        return {"batches": len(batches), "loss_sum": float(sum(losses)),
                "losses": losses}

    def _batch_keys(self, batch):
        if self.keys_fn is not None:
            return self.keys_fn(batch)
        if len(self.caches) == 1 and isinstance(batch, (tuple, list)):
            return {self.caches[0].table_id:
                    host_array(batch[0], np.int64).astype(np.uint64)}
        raise RuntimeError(
            "pass keys_fn(batch) -> {table_id: ids} when the model has "
            "multiple cached embeddings or a custom batch layout")
