"""Bucketed serving engine over saved artifacts (counterpart:
``paddle_tpu/serving/engine.py``).

What the reference does, and what the port keeps:

- **Sources.** ``Engine(model)`` takes an artifact path prefix (what
  ``jit.save(layer, path, input_spec=...)`` wrote), an
  ``inference.Config`` or a loaded ``jit.export.ServedProgram``: the
  exported ``torch.export`` program serves with no access to the model's
  class. :meth:`Engine.from_layer` serves a live layer (a deep copy in eval
  mode, taken at load) as a bridge.
- **Bucket ladder, every capture at load.** A batch of any row count is
  padded up to the smallest bucket that fits and its rows are sliced back
  out; requests larger than the top bucket are chunked. The reference
  compiles one executable per bucket at load; on the card the port
  captures one CUDA graph per bucket at load instead, on the serving
  thread, after an eager warm-up forward (kernels built, cuDNN plans and
  autotuning, which torch keeps per thread, library workspaces). Each
  bucket's graph reads static feed buffers and writes static outputs; all
  buckets share one graph memory pool, and every bucket's buffers stay
  alive, so replays in any bucket order give the eager forward's bits. A
  request copies its batch into the feed buffers, replays and copies the
  outputs out. A capture that fails raises at load, naming the bucket:
  there is no eager fallback. On the CPU the engine runs eagerly.
- **Concurrent dynamic batching** (``batching.py``): in-flight requests
  coalesce into one bucketed batch per device step; callers hold futures.
- **Load-time passes** (``passes.py``): ``outputs=`` prunes the exported
  graph to the fetched outputs; ``bf16`` rewrites a live layer (an
  artifact's dtypes are frozen, so there it raises).
- **Latency SLO telemetry**: queue-wait/pad/device/request spans
  (tracing category ``serving``), ``serving_requests_total{bucket=}``
  counters, the ``serving_batch_fill_ratio`` gauge and p50/p95/p99
  summaries (``serving_latency_ms``, ``serving_queue_wait_ms``,
  ``serving_device_ms``) in both exporters (``observability.export``).
- **Graceful degradation**: ``max_pending`` sheds load with
  :class:`OverloadedError`; ``request_deadline_ms`` expires queued
  requests with :class:`DeadlineExceeded`; :meth:`Engine.health` is
  registered on ``/healthz`` for the engine's life.

Results are numpy arrays, as in the reference. numpy has no bfloat16, so
bfloat16 outputs come back as float32 (an exact widening, made on the
device inside the graph).
"""
import contextlib
import copy
import gc
import itertools
import threading
import time as _time
from concurrent import futures

import numpy as np
import torch

from .. import monitor as _monitor
from ..core import dispatch as _dispatch
from ..core.device import resolve_device
from ..core.dtype import convert_dtype, to_numpy_dtype
from ..kernels.graph_while import bodies_of
from ..observability import export as _export
from ..observability import memory as _memory
from ..observability import runlog as _runlog
from ..observability import tracing as _obs
from ..testing import faults as _faults
from .batching import (DeadlineExceeded, DynamicBatcher, OverloadedError,
                       Request)
from .passes import (apply_passes, cast_feed, check_artifact_passes,
                     prune_outputs, validate_passes)

__all__ = ["Engine", "create_engine", "DEFAULT_BUCKET_LADDER",
           "OverloadedError", "DeadlineExceeded"]

DEFAULT_BUCKET_LADDER = (1, 4, 16, 64)

# health-component names for concurrent engines (itertools.count: atomic
# __next__, so racing constructors never share a name)
_ENGINE_SEQ = itertools.count(1)


def _select_outputs(all_names, outputs):
    if outputs is None:
        return list(range(len(all_names))), list(all_names)
    keep = []
    for name in outputs:
        if name not in all_names:
            raise ValueError(
                f"unknown output {name!r}; valid output names: {all_names}")
        keep.append(all_names.index(name))
    return keep, list(outputs)


def _served_dtype(dtype):
    """The dtype an output is served in: bfloat16 widens to float32."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


class _Prepared:
    """A model source after the load-time passes: ``forward(feeds) ->
    tuple(outputs)`` on device tensors of the declared dtypes, with its
    signature and parameter bytes."""

    def __init__(self, forward, device, input_names, input_specs,
                 output_names, param_bytes, module=None):
        self.forward = forward
        self.module = module  # an artifact's (pruned) graph module
        self.device = device
        self.input_names = input_names
        self.input_specs = input_specs  # [(shape, None batch), torch dtype]
        self.output_names = output_names
        self.param_bytes = param_bytes


class _ArtifactSource:
    """An exported artifact (``jit.export.ServedProgram``): structural
    passes only. ``outputs=`` prunes the program's graph."""

    def __init__(self, served):
        self.served = served

    def prepare(self, passes, outputs):
        check_artifact_passes(passes)
        served = self.served
        keep, out_names = _select_outputs(served.output_names, outputs)
        module = served.graph_module()
        if keep != list(range(len(served.output_names))):
            prune_outputs(module, keep)
        params = served.params

        def forward(feeds):
            outs = module(params, *feeds)
            return tuple(o.to(_served_dtype(o.dtype)) for o in outs)

        specs = [(tuple(shape), dtype)
                 for shape, dtype in served.input_specs]
        return _Prepared(forward, served.device, served.input_names, specs,
                         out_names,
                         sum(p.numel() * p.element_size() for p in params),
                         module)


class _LayerSource:
    """A live layer: a deep copy in eval mode, taken at load, through the
    module passes (``bf16``). Floating outputs come back in the live
    model's dtype (bfloat16 widened to float32)."""

    def __init__(self, layer, input_specs, device):
        self.layer = layer
        self.input_names, self.input_specs = _parse_specs(input_specs)
        self.device = resolve_device(device)
        for name, p in layer.named_parameters():
            if p.device != self.device:
                raise ValueError(
                    f"parameter {name!r} is on {p.device}, the engine "
                    f"serves on {self.device}; build the model there")

    def prepare(self, passes, outputs):
        out_dtype = next((p.dtype for p in self.layer.parameters()
                          if p.dtype.is_floating_point), None)
        out_dtype = None if out_dtype is None else _served_dtype(out_dtype)
        with torch.no_grad():
            module = apply_passes(copy.deepcopy(self.layer).eval(), passes)
        state = itertools.chain(module.parameters(), module.buffers())
        prepared = _Prepared(None, self.device, self.input_names,
                             self.input_specs, None,
                             sum(t.numel() * t.element_size() for t in state))
        keep = None

        def forward(feeds):
            nonlocal keep
            outs = module(*[cast_feed(x, passes) for x in feeds])
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            if keep is None:  # the outputs are known at the first forward
                keep, prepared.output_names = _select_outputs(
                    [f"output_{i}" for i in range(len(outs))], outputs)
            return tuple(
                o.to(out_dtype) if o.dtype.is_floating_point
                and out_dtype is not None else o.to(_served_dtype(o.dtype))
                for o in (outs[i] for i in keep))

        prepared.forward = forward
        return prepared


class _ProgramSource:
    """A recorded ``static.Program`` and the tensors it serves: the load
    pipeline (``passes.build_serving_program``) rewrites it, and the
    served forward replays the result with the fed batch. Floating
    outputs come back in the fetches' own dtypes (bfloat16 widened to
    float32)."""

    def __init__(self, program, fetches, output_names=None):
        self.program = program
        self.fetches = (list(fetches) if isinstance(fetches, (list, tuple))
                        else [fetches])
        self.output_names = output_names or [
            f"output_{i}" for i in range(len(self.fetches))]

    def prepare(self, passes, outputs):
        from .passes import build_serving_program
        keep, out_names = _select_outputs(self.output_names, outputs)
        fetches = [self.fetches[i] for i in keep]
        prog = build_serving_program(self.program, fetches, passes)
        dtypes = [_served_dtype(t.dtype) for t in fetches]
        names = list(prog.feed_vars)
        run = prog._pure([prog.feed_vars[n][0] for n in names],
                         [prog._slot_of(t, create=False) for t in fetches])

        def forward(feeds):
            return tuple(o.to(dt) for o, dt in zip(run(feeds), dtypes))

        specs = [(tuple(None if d in (None, -1) else int(d)
                        for d in prog.feed_vars[n][1]),
                  convert_dtype(prog.feed_vars[n][2])) for n in names]
        params = list(prog.params.values())
        devices = {t.device for t in params}
        if len(devices) != 1:
            raise ValueError(f"the program's tensors are on "
                             f"{sorted(map(str, devices))}; serve from one")
        return _Prepared(forward, devices.pop(), names, specs, out_names,
                         sum(t.numel() * t.element_size() for t in params))


def _parse_specs(input_specs):
    """[InputSpec | (shape, dtype[, name])] -> names, [(shape with None
    batch, torch dtype)]."""
    from ..jit.to_static import InputSpec
    names, specs = [], []
    for i, spec in enumerate(input_specs):
        if isinstance(spec, InputSpec):
            spec = (spec.shape, spec.dtype, spec.name)
        shape = tuple(None if d is None or int(d) < 0 else int(d)
                      for d in spec[0])
        dtype = convert_dtype(spec[1] if len(spec) > 1 else "float32")
        names.append(spec[2] if len(spec) > 2 and spec[2] else f"x{i}")
        specs.append((shape, dtype))
    return names, specs


class _BucketGraph:
    """One bucket's CUDA graph: static feeds in, static outputs out."""

    def __init__(self, bucket, feeds):
        self.bucket = bucket
        self.feeds = feeds
        self.graph = None
        self.outputs = None
        self.capture_ms = None
        self.temp_bytes = None

    def capture(self, forward, pool, device):
        """Capture ``forward(feeds)``; records the capture's time and the
        pool memory it needed beyond its outputs."""
        t0 = _time.perf_counter()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        self.graph = torch.cuda.CUDAGraph()
        # a graph that Python's collector frees during a capture
        # invalidates it: collect now and not during the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # no op observer runs under a capture (a host read breaks it)
            with _dispatch.static_scope(), torch.cuda.graph(
                    self.graph, pool=pool), bodies_of(self.graph):
                self.outputs = forward(self.feeds)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
        self.temp_bytes = max(peak - sum(o.numel() * o.element_size()
                                         for o in self.outputs), 0)
        self.capture_ms = (_time.perf_counter() - t0) * 1e3

    def replay(self):
        self.graph.replay()
        return self.outputs


class Engine:
    """Serving engine: ``len(bucket_ladder)`` batch shapes, each captured
    as a CUDA graph at load on the card, serve arbitrary concurrent
    ragged-batch traffic.

    ``model`` may be an artifact path prefix (or ``inference.Config``), a
    loaded ``ServedProgram``, or come via :meth:`from_layer`. ``passes``:
    subset of ``{"bf16", "donate"}``. ``outputs``: optional subset of
    output names to serve (the exported graph is pruned to them).
    ``device``: where a path or Config is loaded (default ``cuda``).

    Graceful degradation: ``max_pending`` caps the request queue, the
    excess fast-fails with :class:`OverloadedError`
    (``serving_shed_total``); ``request_deadline_ms`` gives each request a
    deadline, and one that expires while queued resolves with
    :class:`DeadlineExceeded` (``serving_deadline_expired_total``) without
    a device step. :meth:`health` is the readiness snapshot, registered on
    the ``/healthz`` endpoint of ``observability.export.start_http_server``
    for the engine's life.
    """

    def __init__(self, model, bucket_ladder=DEFAULT_BUCKET_LADDER,
                 max_batch_size=None, batch_timeout_ms=2.0, passes=(),
                 outputs=None, max_pending=None, request_deadline_ms=None,
                 device=None, _source=None):
        from ..jit.export import ServedProgram
        self._passes = tuple(passes)
        validate_passes(self._passes)
        if _source is None:
            if isinstance(model, ServedProgram):
                if device is not None and \
                        resolve_device(device) != model.device:
                    raise ValueError(
                        f"the ServedProgram is on {model.device}, not "
                        f"{device}; load it there")
                _source = _ArtifactSource(model)
            else:
                _source = _ArtifactSource(self._load_artifact(model,
                                                              device))
        self._prep = _source.prepare(self._passes, outputs)
        self.device = self._prep.device

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
        # drop buckets no batch can ever reach: capturing them is wasted
        # load time
        cap = next(b for b in ladder if b >= self.max_batch_size)
        self.bucket_ladder = tuple(b for b in ladder if b <= cap)
        self._check_specs()
        if request_deadline_ms is not None \
                and float(request_deadline_ms) <= 0:
            raise ValueError(f"request_deadline_ms must be > 0, got "
                             f"{request_deadline_ms!r}")
        self.request_deadline_ms = (None if request_deadline_ms is None
                                    else float(request_deadline_ms))
        self.max_pending = max_pending

        self._cuda = self.device.type == "cuda"
        # one CUDA graph per bucket (the units chip_smoke's count_replays
        # reads); False serves the same buckets eagerly, a seam for
        # measuring what the graphs save, never a fallback
        self._programs = {}
        self._graphs_on = self._cuda
        self._pool = None
        self._memory = {}
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
                       "warmup_ms": {}, "capture_ms": {}}
        # the summary boards, resolved once: the request path must not
        # take the registry lock per request
        self._lat_summary = _export.summary("serving_latency_ms")
        self._wait_summary = _export.summary("serving_queue_wait_ms")
        self._dev_summary = _export.summary("serving_device_ms")
        self._closed = False
        self._batcher = DynamicBatcher(self._run_batch, self.max_batch_size,
                                       batch_timeout_ms,
                                       max_pending=max_pending,
                                       on_expired=self._on_expired,
                                       on_start=self._load)
        self._batcher.started.result()  # the load's error, if any
        self._health_name = f"serving_engine_{next(_ENGINE_SEQ)}"
        _export.register_health(self._health_name, self.health)

    # -- construction ------------------------------------------------------
    @staticmethod
    def _load_artifact(model, device):
        from ..inference import Config
        from ..jit.export import ServedProgram, has_artifact
        params_path = None
        if isinstance(model, Config):
            if device is None:
                device = model._device
            model, params_path = model.model_path, model.params_path
        if not isinstance(model, str):
            raise TypeError(
                "Engine(model) takes an artifact path prefix, an "
                "inference.Config, or a ServedProgram; for live layers use "
                f"Engine.from_layer (got {type(model).__name__})")
        if model.endswith(".pdmodel"):
            model = model[:-len(".pdmodel")]
        if not has_artifact(model, params_path=params_path):
            raise FileNotFoundError(
                f"no exported artifact at {model!r}; save one with "
                "jit.save(layer, path, input_spec=[...]); pickled layers "
                "serve through Engine.from_layer")
        return ServedProgram(model, params_path=params_path, device=device)

    @classmethod
    def from_layer(cls, layer, input_specs, **kwargs):
        """Serve a live layer; ``input_specs`` is ``[InputSpec | (shape,
        dtype[, name])]`` with ``None`` for the batch axis. ``device``
        (default ``cuda``) must hold the layer's parameters."""
        device = kwargs.pop("device", None)
        return cls(None, _source=_LayerSource(layer, input_specs, device),
                   **kwargs)

    @classmethod
    def from_program(cls, program, fetches, output_names=None, **kwargs):
        """Serve a recorded ``static.Program``: ``fetches`` (its tensors)
        are the served outputs; the program runs on the device of its
        parameters. A feed dimension read as a shape during the build is a
        constant of the program (the reference's rule), so a program whose
        batch axis was built at 1 serves at bucket 1 only."""
        if "device" in kwargs:
            raise TypeError("Engine.from_program serves on the device of the "
                            "program's parameters; it takes no device=")
        return cls(None, _source=_ProgramSource(program, fetches,
                                                output_names), **kwargs)

    def _check_specs(self):
        names, specs = self._prep.input_names, self._prep.input_specs
        bad = [n for n, (shape, _dt) in zip(names, specs)
               if not shape or shape[0] is not None]
        if bad:
            raise ValueError(
                f"inputs {bad} are not batch-polymorphic on axis 0; the "
                "engine buckets the batch axis — export with "
                "InputSpec([None, ...])")
        bad = [n for n, (shape, _dt) in zip(names, specs)
               if any(d is None for d in shape[1:])]
        if bad:
            raise ValueError(
                f"inputs {bad} have dynamic non-batch dims; the engine "
                "buckets only the batch axis — fix the other dims at "
                "export time")

    def _zeros(self, bucket):
        return [np.zeros((bucket,) + shape[1:], to_numpy_dtype(dtype))
                for shape, dtype in self._prep.input_specs]

    def _load(self):
        """On the serving thread: per bucket one eager warm-up forward,
        then (on the card) the bucket's CUDA graph."""
        ctx = (torch.cuda.device(self.device) if self._cuda
               else contextlib.nullcontext())
        with ctx, torch.inference_mode():
            if self._cuda:
                self._pool = torch.cuda.graph_pool_handle()
            for b in self.bucket_ladder:
                t0 = _time.perf_counter()
                feeds = [torch.from_numpy(c).to(self.device)
                         for c in self._zeros(b)]
                outs = self._prep.forward(feeds)
                bad = [name for name, o in zip(self._prep.output_names,
                                               outs)
                       if o.dim() == 0 or o.shape[0] != b]
                if bad:
                    raise ValueError(
                        f"outputs {bad} are not batch-major (axis 0 != "
                        "batch size); the engine cannot slice per-request "
                        "results — serve batch-major outputs (outputs=)")
                if self._cuda:
                    torch.cuda.synchronize(self.device)
                self._stats["warmup_runs"] += 1
                self._stats["warmup_ms"][b] = \
                    (_time.perf_counter() - t0) * 1e3
                self._memory[b] = {
                    "argument_bytes": self._prep.param_bytes + sum(
                        f.numel() * f.element_size() for f in feeds),
                    "output_bytes": sum(o.numel() * o.element_size()
                                        for o in outs)}
                del outs
                if self._cuda:
                    self._capture(b, feeds)

    def _capture(self, bucket, feeds):
        unit = _BucketGraph(bucket, feeds)
        t0 = _obs.now_ns()
        try:
            with _obs.trace_span("serving/capture", cat="serving",
                                 bucket=bucket):
                unit.capture(self._prep.forward, self._pool, self.device)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of bucket {bucket} failed: "
                f"{type(e).__name__}: {e}") from e
        self._programs[bucket] = unit
        self._stats["capture_ms"][bucket] = unit.capture_ms
        _monitor.stat_add("serving_graph_captures", 1)
        _monitor.stat_add("serving_graph_capture_ns", _obs.now_ns() - t0)
        _obs.record_compile("capture", t0, _obs.now_ns(), bucket=bucket)

    # -- public surface ----------------------------------------------------
    @property
    def input_names(self):
        return list(self._prep.input_names)

    @property
    def output_names(self):
        return list(self._prep.output_names)

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
        ``deadline_ms`` overrides the engine's ``request_deadline_ms``;
        raises :class:`OverloadedError` when admission control sheds it."""
        arrays = self._validate(inputs)
        if deadline_ms is None:
            deadline_ms = self.request_deadline_ms
        deadline = (None if deadline_ms is None
                    else _time.perf_counter() + float(deadline_ms) / 1e3)
        rows = arrays[0].shape[0]
        if rows <= self.max_batch_size:
            return self._submit_one(self._make_request(arrays, rows,
                                                       deadline))
        with self._lock:
            self._stats["chunked_requests"] += 1
        chunk = self.max_batch_size
        parts = []
        for off in range(0, rows, chunk):
            part = tuple(a[off:off + chunk] for a in arrays)
            try:
                parts.append(self._submit_one(
                    self._make_request(part, part[0].shape[0], deadline)))
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

    run = predict  # Predictor-style alias

    def memory_stats(self):
        """Per-bucket device memory: ``{bucket: {argument_bytes
        (parameters + feeds), output_bytes, temp_bytes (the graph pool's
        peak during the bucket's capture beyond its outputs; None on the
        CPU, which captures nothing), alias_bytes, generated_code_bytes
        (0: no buffer donation, no generated code), peak_bytes}}``. The
        capture reads the device's peak-memory counter, which it resets.
        Each captured bucket is recorded in the program-memory registry
        (``observability.memory``) as ``serving_b<bucket>``, as the
        reference records its bucket executables."""
        out = {}
        for b in self.bucket_ladder:
            m = dict(self._memory[b])
            unit = self._programs.get(b)
            m["temp_bytes"] = None if unit is None else unit.temp_bytes
            m["alias_bytes"] = 0
            m["generated_code_bytes"] = 0
            m["peak_bytes"] = (None if m["temp_bytes"] is None else
                               m["argument_bytes"] + m["output_bytes"]
                               + m["temp_bytes"])
            out[b] = m
            if unit is not None:
                _memory.record_program_memory(f"serving_b{b}", m)
        return out

    def stats(self):
        with self._lock:
            s = dict(self._stats)
            for key in ("batches_by_bucket", "device_ms_by_bucket",
                        "copy_ms_by_bucket", "warmup_ms", "capture_ms"):
                s[key] = dict(s[key])
        s["executables"] = len(self._programs)
        s["bucket_ladder"] = self.bucket_ladder
        s["pending"] = self._batcher.pending()
        s["max_pending"] = self.max_pending
        s["passes"] = self._passes
        s["device"] = str(self.device)
        return s

    def health(self):
        """Readiness snapshot, registered on ``/healthz`` for the engine's
        life: ``status`` is "ok" while the worker is serviceable, "closed"
        after close(), "dead" if the worker thread crashed."""
        if self._closed:
            status = "closed"
        elif not self._batcher.alive():
            status = "dead"
        else:
            status = "ok"
        with self._lock:
            shed = self._stats["shed"]
            expired = self._stats["deadline_expired"]
            errors = self._stats["errors"]
            served = self._stats["requests"]
        return {"status": status, "ready": status == "ok",
                "executables": len(self._programs),
                "bucket_ladder": list(self.bucket_ladder),
                "device": str(self.device),
                "pending": self._batcher.pending(),
                "max_pending": self.max_pending,
                "requests_total": served, "errors_total": errors,
                "shed_total": shed, "deadline_expired_total": expired}

    def close(self, timeout=30):
        """Drain queued requests, stop the batcher thread and drop the
        engine's health component. A failed drain (a wedged device step)
        keeps the component registered: its "closed"/"dead" status makes
        /healthz answer 503, which is when a load balancer must stop
        routing here."""
        self._closed = True
        self._batcher.close(timeout=timeout)
        _export.unregister_health(self._health_name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- request path ------------------------------------------------------
    def _make_request(self, arrays, rows, deadline):
        """A Request; with serving tracing on it also gets a request-span
        identity minted in the caller's trace context."""
        r = Request(arrays, rows, deadline=deadline)
        if _obs.enabled("serving"):
            r.ctx = _obs.mint_context()
            r.t0_ns = _obs.now_ns()
        return r

    def _submit_one(self, request):
        try:
            return self._batcher.submit(request)
        except OverloadedError:
            with self._lock:
                self._stats["shed"] += 1
            _monitor.stat_add("serving_shed_total", 1)
            _runlog.event("serving_shed", rows=request.rows)
            raise

    def _on_expired(self, request):
        with self._lock:
            self._stats["deadline_expired"] += 1
        _monitor.stat_add("serving_deadline_expired_total", 1)
        _runlog.event("serving_deadline_expired", rows=request.rows)
        if request.ctx:
            _obs.record_span("serving/request", "serving", request.t0_ns,
                             _obs.now_ns(), trace_id=request.ctx[0],
                             span_id=request.ctx[1],
                             parent_id=request.ctx[2], rows=request.rows,
                             status="deadline_expired")

    def _validate(self, inputs):
        specs = self._prep.input_specs
        if len(inputs) != len(specs):
            raise ValueError(
                f"expected {len(specs)} inputs {self._prep.input_names}, "
                f"got {len(inputs)}")
        arrays = []
        rows = None
        for name, (shape, dtype), x in zip(self._prep.input_names, specs,
                                           inputs):
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

    def _device_step(self, bucket, cols):
        """One device step: numpy feeds in, numpy outputs out. Returns
        (outputs, device ms, host-copy ms): the device part ends in a
        synchronise, the copy to the host is the rest."""
        ctx = (torch.cuda.device(self.device) if self._cuda
               else contextlib.nullcontext())
        with ctx, torch.inference_mode():
            t0 = _time.perf_counter()
            unit = self._programs.get(bucket) if self._graphs_on else None
            if unit is not None:
                for buf, c in zip(unit.feeds, cols):
                    buf.copy_(torch.from_numpy(c))
                outs = unit.replay()
            else:
                outs = self._prep.forward([torch.from_numpy(c).to(
                    self.device) for c in cols])
            if self._cuda:
                torch.cuda.synchronize(self.device)
            t1 = _time.perf_counter()
            res = [o.cpu().numpy() for o in outs]
            t2 = _time.perf_counter()
        return res, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    def _run_batch(self, batch):
        t_start = _obs.now_ns()
        tracing = _obs.enabled("serving")
        now = _time.perf_counter()
        for r in batch:
            wait_ns = int((now - r.t_enqueue) * 1e9)
            if tracing and r.ctx:
                # retrospective queue-wait span inside the request's own
                # trace: a p99 outlier splits into queue, pad and device
                _obs.record_span("serving/queue_wait", "serving",
                                 t_start - wait_ns, t_start,
                                 trace_id=r.ctx[0], parent_id=r.ctx[1])
            self._wait_summary.observe(wait_ns / 1e6)

        rows = sum(r.rows for r in batch)
        bucket = self.bucket_for(rows)
        pad = bucket - rows
        # the batch span is its own trace (it serves many requests) and
        # links to every co-batched request's span; request spans link back
        links = ([f"{r.ctx[0]:016x}:{r.ctx[1]:016x}"
                  for r in batch if r.ctx] if tracing else None)
        batch_span = _obs.trace_span(
            "serving/batch", cat="serving", rows=rows, bucket=bucket,
            requests=len(batch), **({"links": links} if links else {}))
        with batch_span:
            # obs.disable() can race this worker between the enabled()
            # snapshot and trace_span, handing back the no-op span
            tracing = tracing and batch_span is not _obs.NULL_SPAN
            batch_ref = (f"{batch_span.trace_id:016x}:"
                         f"{batch_span.span_id:016x}" if tracing else None)
            with _obs.trace_span("serving/pad", cat="serving", rows=rows,
                                 bucket=bucket):
                cols = []
                for i, (shape, dtype) in enumerate(self._prep.input_specs):
                    parts = [r.inputs[i] for r in batch]
                    if pad:
                        parts.append(np.zeros((pad,) + tuple(shape[1:]),
                                              to_numpy_dtype(dtype)))
                    cols.append(parts[0] if len(parts) == 1
                                else np.concatenate(parts, axis=0))
            try:
                with _obs.trace_span("serving/device_step", cat="serving",
                                     bucket=bucket, requests=len(batch)):
                    # chaos seam: an injected device-step failure takes
                    # the path of a real one (every future resolves with
                    # the exception; the worker stays serviceable)
                    _faults.kill_point("serving/device_step")
                    outs, dev_ms, copy_ms = self._device_step(bucket, cols)
            except Exception as e:  # noqa: BLE001 — resolve every future
                with self._lock:
                    self._stats["errors"] += len(batch)
                _monitor.stat_add("serving_request_errors_total",
                                  len(batch))
                end_ns = _obs.now_ns()
                for r in batch:
                    if tracing and r.ctx:
                        _obs.record_span(
                            "serving/request", "serving", r.t0_ns, end_ns,
                            trace_id=r.ctx[0], span_id=r.ctx[1],
                            parent_id=r.ctx[2], rows=r.rows,
                            error=type(e).__name__,
                            **({"links": [batch_ref]} if batch_ref
                               else {}))
                    _resolve(r.future, exception=e)
                return

            # telemetry BEFORE resolving futures: a caller woken by its
            # future must see this batch already accounted in stats()
            self._dev_summary.observe(dev_ms)
            _monitor.stat_add(
                "serving_requests_total"
                + _export.format_labels("serving_requests_total",
                                        bucket=bucket), len(batch))
            _monitor.stat_add(
                "serving_batches_total"
                + _export.format_labels("serving_batches_total",
                                        bucket=bucket), 1)
            if pad:
                _monitor.stat_add("serving_padded_rows_total", pad)
            _export.publish("serving", {"batch_fill_ratio": rows / bucket})
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
            done = _time.perf_counter()
            end_ns = _obs.now_ns()
            whole = len(batch) == 1 and not pad
            for r in batch:
                self._lat_summary.observe((done - r.t_enqueue) * 1e3)
                if tracing and r.ctx:
                    _obs.record_span(
                        "serving/request", "serving", r.t0_ns, end_ns,
                        trace_id=r.ctx[0], span_id=r.ctx[1],
                        parent_id=r.ctx[2], rows=r.rows, bucket=bucket,
                        **({"links": [batch_ref]} if batch_ref else {}))
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


def create_engine(config, **kwargs):
    """An Engine from an ``inference.Config`` or artifact path (mirrors
    ``inference.create_predictor``)."""
    return Engine(config, **kwargs)
