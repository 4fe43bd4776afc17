"""Bucketed serving engine (counterpart: ``paddle_tpu/serving/engine.py``).

What the reference does, and what the port keeps:

- **Bucket ladder.** A batch of any row count is padded up to the
  smallest bucket that fits and its rows are sliced back out; requests
  larger than the top bucket are chunked. The reference compiles one
  executable per bucket at load; the port runs eagerly, so load runs one
  warm-up forward per bucket on the device instead (kernels built, memory
  pools and library handles set up), and the first request builds nothing.
  The warm-up runs on the thread that serves the requests: torch keeps
  cuDNN's handles, execution plans and autotuning results per thread, so
  a warm-up on another thread would leave each bucket's first served
  batch to build (and with ``cudnn.benchmark``, autotune) them again.
- **Concurrent dynamic batching** (``batching.py``): in-flight requests
  coalesce into one bucketed batch per device step; callers hold futures.
- **Load-time passes** (``passes.py``): the ``bf16`` pass.
- **Graceful degradation**: ``max_pending`` sheds load with
  :class:`OverloadedError`; ``request_deadline_ms`` expires queued
  requests with :class:`DeadlineExceeded`.

The engine serves a snapshot of the live model taken at load (a deep
copy, in eval mode), as the reference serves the parameter values it
captured at load. Results are numpy arrays, as in the reference.
"""
import contextlib
import copy
import threading
import time as _time
from concurrent import futures

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype, to_numpy_dtype
from .batching import (DeadlineExceeded, DynamicBatcher, OverloadedError,
                       Request)
from .passes import apply_passes, cast_feed, validate_passes

__all__ = ["Engine", "DEFAULT_BUCKET_LADDER", "OverloadedError",
           "DeadlineExceeded"]

DEFAULT_BUCKET_LADDER = (1, 4, 16, 64)


def _parse_specs(input_specs):
    """[(shape, dtype[, name])] -> names, [(shape with None batch, torch
    dtype)]; the batch axis must be polymorphic and the rest fixed."""
    names, specs = [], []
    for i, spec in enumerate(input_specs):
        shape = tuple(None if d is None or int(d) < 0 else int(d)
                      for d in spec[0])
        dtype = convert_dtype(spec[1] if len(spec) > 1 else "float32")
        name = spec[2] if len(spec) > 2 and spec[2] else f"x{i}"
        if not shape or shape[0] is not None:
            raise ValueError(
                f"input {name!r} is not batch-polymorphic on axis 0; the "
                "engine buckets the batch axis — declare its shape as "
                "[None, ...]")
        if any(d is None for d in shape[1:]):
            raise ValueError(
                f"input {name!r} has dynamic non-batch dims; the engine "
                "buckets only the batch axis — fix the other dims")
        names.append(name)
        specs.append((shape, dtype))
    return names, specs


def _model_dtype(layer):
    """The live model's float dtype: the declared dtype of its floating
    outputs (None if it has no floating parameter)."""
    for p in layer.parameters():
        if p.dtype.is_floating_point:
            return p.dtype
    return None


class Engine:
    """Serving engine: ``len(bucket_ladder)`` warmed batch shapes serve
    arbitrary concurrent ragged-batch traffic. Build it with
    :meth:`from_layer`. ``passes``: subset of ``{"bf16", "donate"}``.
    """

    def __init__(self, layer, input_specs, bucket_ladder=DEFAULT_BUCKET_LADDER,
                 max_batch_size=None, batch_timeout_ms=2.0, passes=(),
                 max_pending=None, request_deadline_ms=None, device=None):
        self.device = resolve_device(device)
        self._passes = tuple(passes)
        validate_passes(self._passes)
        self._input_names, self._input_specs = _parse_specs(input_specs)
        for name, p in layer.named_parameters():
            if p.device != self.device:
                raise ValueError(
                    f"parameter {name!r} is on {p.device}, the engine "
                    f"serves on {self.device}; build the model there")

        ladder = sorted({int(b) for b in bucket_ladder})
        if not ladder or ladder[0] < 1:
            raise ValueError(f"bucket_ladder must be positive ints, got "
                             f"{bucket_ladder!r}")
        if max_batch_size is not None:
            if int(max_batch_size) < 1:
                raise ValueError(
                    f"max_batch_size must be >= 1, got {max_batch_size!r} "
                    "(use max_batch_size=1 to disable coalescing)")
            if int(max_batch_size) > ladder[-1]:
                raise ValueError(
                    f"max_batch_size={max_batch_size} exceeds the top "
                    f"bucket {ladder[-1]}; raise the bucket ladder instead")
        self.max_batch_size = int(max_batch_size or ladder[-1])
        # drop buckets no batch can ever reach: warming them is wasted load
        cap = next(b for b in ladder if b >= self.max_batch_size)
        self.bucket_ladder = tuple(b for b in ladder if b <= cap)
        if request_deadline_ms is not None \
                and float(request_deadline_ms) <= 0:
            raise ValueError(f"request_deadline_ms must be > 0, got "
                             f"{request_deadline_ms!r}")
        self.request_deadline_ms = (None if request_deadline_ms is None
                                    else float(request_deadline_ms))
        self.max_pending = max_pending

        # ---- load: snapshot, passes, one warm-up forward per bucket
        self._out_dtype = _model_dtype(layer)
        with torch.no_grad():
            self._module = apply_passes(copy.deepcopy(layer).eval(),
                                        self._passes)
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0,
                       "multi_request_batches": 0, "padded_rows": 0,
                       "errors": 0, "chunked_requests": 0, "shed": 0,
                       "deadline_expired": 0, "warmup_runs": 0,
                       "batches_by_bucket": {b: 0 for b in self.bucket_ladder},
                       "device_ms_by_bucket": {b: 0.0
                                               for b in self.bucket_ladder},
                       "copy_ms_by_bucket": {b: 0.0
                                             for b in self.bucket_ladder},
                       "warmup_ms": {}}
        self._batcher = DynamicBatcher(self._run_batch, self.max_batch_size,
                                       batch_timeout_ms,
                                       max_pending=max_pending,
                                       on_expired=self._on_expired,
                                       on_start=self._warm_up)
        self._batcher.started.result()  # the warm-up's error, if any

    def _warm_up(self):
        """One forward per bucket, on the serving thread."""
        for b in self.bucket_ladder:
            t0 = _time.perf_counter()
            outs, _, _ = self._forward([np.zeros((b,) + shape[1:],
                                                 to_numpy_dtype(dtype))
                                        for shape, dtype in self._input_specs])
            bad = [i for i, o in enumerate(outs)
                   if o.ndim == 0 or o.shape[0] != b]
            if bad:
                raise ValueError(
                    f"outputs {bad} are not batch-major (axis 0 != batch "
                    "size); the engine cannot slice per-request results")
            self._stats["warmup_runs"] += 1
            self._stats["warmup_ms"][b] = (_time.perf_counter() - t0) * 1e3

    @classmethod
    def from_layer(cls, layer, input_specs, **kwargs):
        """Serve a live Layer; ``input_specs`` is ``[(shape, dtype[,
        name])]`` with ``None`` for the batch axis."""
        return cls(layer, input_specs, **kwargs)

    # -- public surface ----------------------------------------------------
    def bucket_for(self, rows):
        """Smallest ladder bucket that fits `rows` (rows must be <=
        max_batch_size; submit() chunks bigger requests)."""
        for b in self.bucket_ladder:
            if b >= rows:
                return b
        raise ValueError(f"{rows} rows exceed the largest bucket "
                         f"{self.bucket_ladder[-1]}")

    def submit(self, *inputs, deadline_ms=None):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to ``[output arrays]`` (batch rows match the request).
        Requests larger than the top bucket are chunked transparently.
        Raises :class:`OverloadedError` when admission control sheds it."""
        arrays = self._validate(inputs)
        if deadline_ms is None:
            deadline_ms = self.request_deadline_ms
        deadline = (None if deadline_ms is None
                    else _time.perf_counter() + float(deadline_ms) / 1e3)
        rows = arrays[0].shape[0]
        if rows <= self.max_batch_size:
            return self._submit_one(Request(arrays, rows, deadline=deadline))
        with self._lock:
            self._stats["chunked_requests"] += 1
        chunk = self.max_batch_size
        parts = []
        for off in range(0, rows, chunk):
            part = tuple(a[off:off + chunk] for a in arrays)
            try:
                parts.append(self._submit_one(
                    Request(part, part[0].shape[0], deadline=deadline)))
            except OverloadedError:
                # all-or-nothing admission: roll back the queued chunks
                for f in parts:
                    f.cancel()
                raise
        return _concat_future(parts)

    def predict(self, *inputs, deadline_ms=None):
        """Synchronous request: submit + wait. Thread-safe — N caller
        threads coalesce into shared device steps."""
        return self.submit(*inputs, deadline_ms=deadline_ms).result()

    def stats(self):
        with self._lock:
            s = dict(self._stats)
            for key in ("batches_by_bucket", "device_ms_by_bucket",
                        "copy_ms_by_bucket", "warmup_ms"):
                s[key] = dict(s[key])
        s["bucket_ladder"] = self.bucket_ladder
        s["pending"] = self._batcher.pending()
        s["max_pending"] = self.max_pending
        s["passes"] = self._passes
        s["device"] = str(self.device)
        return s

    def close(self, timeout=30):
        """Drain queued requests and stop the batcher thread."""
        self._batcher.close(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- request path ------------------------------------------------------
    def _submit_one(self, request):
        try:
            return self._batcher.submit(request)
        except OverloadedError:
            with self._lock:
                self._stats["shed"] += 1
            raise

    def _on_expired(self, request):
        with self._lock:
            self._stats["deadline_expired"] += 1

    def _validate(self, inputs):
        if len(inputs) != len(self._input_specs):
            raise ValueError(
                f"expected {len(self._input_specs)} inputs "
                f"{self._input_names}, got {len(inputs)}")
        arrays = []
        rows = None
        for name, (shape, dtype), x in zip(self._input_names,
                                           self._input_specs, inputs):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            # always a fresh buffer: the request sits queued up to
            # batch_timeout_ms, and a caller mutating its array after
            # submit() must not corrupt the batch
            a = np.array(x, dtype=to_numpy_dtype(dtype), copy=True)
            if a.ndim != len(shape) or tuple(a.shape[1:]) != tuple(shape[1:]):
                raise ValueError(
                    f"input {name!r}: got shape {tuple(a.shape)}, expected "
                    f"(batch, {', '.join(str(d) for d in shape[1:])})")
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise ValueError(
                    f"input {name!r}: batch dim {a.shape[0]} != {rows} of "
                    "the other inputs")
            arrays.append(a)
        if rows == 0:
            raise ValueError("empty request (batch dim 0)")
        return tuple(arrays)

    def _forward(self, cols):
        """One device step: numpy feeds in, numpy outputs (declared dtype)
        out. Returns (outputs, device ms, host-copy ms): the device part
        ends in a synchronise, the copy to the host is the rest."""
        cuda = self.device.type == "cuda"
        ctx = (torch.cuda.device(self.device) if cuda
               else contextlib.nullcontext())
        with ctx, torch.inference_mode():
            t0 = _time.perf_counter()
            feeds = [cast_feed(torch.from_numpy(c).to(self.device),
                               self._passes) for c in cols]
            outs = self._module(*feeds)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            outs = [o.to(self._out_dtype) if o.dtype.is_floating_point
                    and self._out_dtype is not None else o for o in outs]
            if cuda:
                torch.cuda.synchronize(self.device)
            t1 = _time.perf_counter()
            res = [o.cpu().numpy() for o in outs]
            t2 = _time.perf_counter()
        return res, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    def _run_batch(self, batch):
        rows = sum(r.rows for r in batch)
        bucket = self.bucket_for(rows)
        pad = bucket - rows
        cols = []
        for i, (shape, dtype) in enumerate(self._input_specs):
            parts = [r.inputs[i] for r in batch]
            if pad:
                parts.append(np.zeros((pad,) + tuple(shape[1:]),
                                      to_numpy_dtype(dtype)))
            cols.append(parts[0] if len(parts) == 1
                        else np.concatenate(parts, axis=0))
        try:
            outs, dev_ms, copy_ms = self._forward(cols)
        except Exception as e:  # noqa: BLE001 — resolve every future
            with self._lock:
                self._stats["errors"] += len(batch)
            for r in batch:
                _resolve(r.future, exception=e)
            return

        # stats BEFORE resolving futures: a caller woken by its future
        # must see this batch already accounted in stats()
        with self._lock:
            self._stats["requests"] += len(batch)
            self._stats["batches"] += 1
            self._stats["batches_by_bucket"][bucket] += 1
            self._stats["device_ms_by_bucket"][bucket] += dev_ms
            self._stats["copy_ms_by_bucket"][bucket] += copy_ms
            self._stats["padded_rows"] += pad
            if len(batch) > 1:
                self._stats["multi_request_batches"] += 1
        off = 0
        whole = len(batch) == 1 and not pad
        for r in batch:
            # copy the row slices out: a view would pin the whole
            # bucket-sized buffer and expose co-batched requests' rows
            _resolve(r.future, result=list(outs) if whole else
                     [o[off:off + r.rows].copy() for o in outs])
            off += r.rows


def _resolve(future, result=None, exception=None):
    """Resolve a request future, tolerating caller-side cancel()."""
    try:
        if exception is not None:
            future.set_exception(exception)
        else:
            future.set_result(result)
    except futures.InvalidStateError:
        pass  # cancelled/already-resolved: the caller walked away


def _concat_future(parts):
    """Aggregate chunk futures into one future resolving to the
    row-concatenated outputs (chunk order preserved)."""
    agg = futures.Future()
    remaining = [len(parts)]
    lock = threading.Lock()

    def _on_done(_f):
        with lock:
            remaining[0] -= 1
            last = remaining[0] == 0
        if agg.done():
            return
        exc = _f.exception() if not _f.cancelled() else None
        if exc is not None or _f.cancelled():
            # first failed chunk decides the aggregate; resolve BEFORE
            # cancelling siblings (their callbacks fire synchronously)
            _resolve(agg, exception=exc if exc is not None
                     else futures.CancelledError())
            for p in parts:
                if p is not _f:
                    p.cancel()
            return
        if last:
            results = [p.result() for p in parts]
            _resolve(agg, result=[
                np.concatenate([r[i] for r in results], axis=0)
                for i in range(len(results[0]))])

    for p in parts:
        p.add_done_callback(_on_done)
    return agg
