"""to_static: a step function as one program, and the k-step program
(counterpart: ``paddle_tpu/jit/to_static.py``, ``to_static`` and
``StaticFunction``).

``to_static(fn)`` runs ``fn`` as one program. ``to_static(fn,
scan_steps=k)`` takes ``fn`` as the single-step body: every tensor argument
arrives ``[k, ...]``-stacked (one microbatch an inner step), the body runs k
times and each per-step output comes back ``[k, ...]``-stacked. Framework
state carries from step to step because it lives in tensors that the body
updates in place: parameters, moments, masters, the optimizer's ``@step``
and ``@lr``, and the RNG. A gradient that the body leaves live accumulates
across the steps (the reference's persistable gradients); one the body
clears is ``None`` afterwards. The stacked outputs are values: they carry
no autograd history (the backward belongs inside the body).

``dp_axis="dp"`` (with ``scan_steps``) runs the program as one rank of the
mesh's data-parallel group (``distributed.parallel_env``): the caller
passes the global ``[k, B, ...]`` batch and this rank takes its ``B/dp``
rows of dim 1 (the reference's ``PartitionSpec(None, dp_axis)``; inputs
that disagree on dim 1 stay whole, with a warning); the optimizer reduces
the gradients over the group, per parameter for a replicated optimizer,
per bucket after ``_zero_enable``; floating outputs come back averaged over
the group. ``accumulate_steps=a`` groups the k inner steps into windows of
a: the first a - 1 steps of a window run in the "accum" phase (the
optimizer and ``clear_grad`` leave the gradients be) and the last in the
"fire" phase (one update over the window's gradients, scaled 1/a).
Programs with a dp axis call the hooks of :func:`register_call_begin_hook`
once a call, before its first step (outside any capture), those of
:func:`register_step_hook` at the start of every inner step and those of
:func:`register_call_end_hook` once a call, after its last step (ZeRO-3
releases, gathers and regathers its parameters there).

Where the program runs is where its tensor arguments are:

- On the CPU it is a plain loop over the body, so its results are bitwise
  those of the same eager calls.
- On the card it is a CUDA graph (``torch.cuda.CUDAGraph``) of one unit:
  one inner step, or one accumulation window of a steps, whose steps are
  not alike. The first call for a signature (the shapes and dtypes of the
  tensors and the values of the other arguments, as the reference keys
  its compile cache) runs unit 0 eagerly on the program's stream from the
  program's static input buffers: those are real steps, and they create
  whatever the body builds lazily (kernel attributes, cuBLAS workspaces,
  NCCL communicators, pinned host buffers) before any capture. Then one
  unit is captured from the same buffers, and every further unit copies
  its microbatches into the buffers and replays the graph. The graph's
  capture time and its memory pool grow with the unit, never with k, as
  the reference's scan traces its body once. The per-step outputs are
  copied into ``[k, ...]`` device tensors; the host reads nothing.

Rules that capture imposes on the body, each enforced where it can be:

- The same kernels run on every replay with the addresses of the capture,
  so inputs are copied into the static buffers and never rebound; the
  hand-written kernels encode their TMA descriptors at capture from those
  addresses and launch on the capture stream (``torch.cuda.current_stream``).
- State is updated in place. Setting the learning rate inside the body
  raises (``optimizer._LRValue.set``); step a scheduler between calls.
- A random draw needs the package's generator registered with the graph
  (``core.random.register_with_graph``), which advances it on every
  replay; where this torch cannot register it, the draw raises.
- No host synchronisation (``.item()``, ``float(tensor)``) inside the body:
  capture refuses it.
- Kernel wrappers do not count launches while a graph is captured, and a
  replay runs no Python: launches under the program are counted from
  the captured graph's kernel nodes (``CUDAGraph(keep_graph=True)``,
  ``debug_dump``) times its replays, or by the profiler.

No op observer (``core.dispatch``: the profiler, the NaN check, the
sampled telemetry) runs while a unit is captured, and a replay runs no
Python, so a replayed call is observed by no one, as the reference's
static trace. A capture is a compile event (``jit_compile_ns``, a ``jit``
span) and a program in ``memory_stats()``: the pool bytes of its capture.

A capture or replay that fails raises; the program never runs eagerly in
its place. ``xla_flags`` and ``donate_state`` are accepted for the
reference's signature and have no effect on CUDA. Not ported: the AST
fallback and ``input_spec``.
"""
import functools
import gc
import warnings
import weakref

import torch

from ..core import dispatch as _dispatch
from ..core import random as _random
from ..distributed import collective as _collective
from ..distributed import parallel_env
from ..observability import memory as _memory
from ..observability import tracing as _tracing

_hooks = {"call_begin": [], "step": [], "call_end": []}


def in_tracing():
    """True while a step program runs its body: a unit being captured or
    run as a program step (on the CPU, a step of the program's loop); the
    counterpart of the reference's "a trace is under way"."""
    return parallel_env.current_program() is not None


def _register(kind, method):
    ref = weakref.WeakMethod(method)
    _hooks[kind] = [r for r in _hooks[kind] if r() is not None] + [ref]


def register_step_hook(method):
    """Call the bound ``method(dp_axis, program)`` at the start of every
    inner step of a program with a dp axis (held weakly, in registration
    order: every rank must issue its collectives alike)."""
    _register("step", method)


def register_call_begin_hook(method):
    """Call the bound ``method(dp_axis, program)`` once at the start of
    every call of a program with a dp axis, before any step, capture or
    replay."""
    _register("call_begin", method)


def register_call_end_hook(method):
    """Call the bound ``method(dp_axis, program)`` once at the end of every
    call of a program with a dp axis."""
    _register("call_end", method)


def _run_hooks(kind, axis, program):
    for ref in list(_hooks[kind]):
        fn = ref()
        if fn is not None:
            fn(axis, program)


def _flatten(tree, leaves):
    """Append the leaves of a nest of tuples, lists and dicts to ``leaves``
    and return a function that rebuilds the nest from a new leaf list."""
    if isinstance(tree, (tuple, list)):
        builders = [_flatten(x, leaves) for x in tree]
        kind = type(tree)
        return lambda it: kind(b(it) for b in builders)
    if isinstance(tree, dict):
        keys = list(tree)
        builders = [_flatten(tree[key], leaves) for key in keys]
        return lambda it: {key: b(it) for key, b in zip(keys, builders)}
    leaves.append(tree)
    return lambda it: next(it)


def _tree(tree):
    """(leaves, rebuild) with ``rebuild(new_leaves)`` the same nest."""
    leaves = []
    build = _flatten(tree, leaves)
    return leaves, lambda new: build(iter(new))


def _structure(tree, leaf):
    """A comparable description of a nest, ``leaf(x)`` describing each
    leaf."""
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(x, leaf) for x in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((key, _structure(v, leaf))
                              for key, v in tree.items()))
    return leaf(tree)


def _output_leaf(x):
    if x is None or isinstance(x, torch.Tensor):
        return x is None
    raise TypeError(f"a step program's outputs must be tensors, None or "
                    f"tuples, lists and dicts of them; got {type(x).__name__}")


def _argument_leaf(x):
    """A tensor by its shape, dtype and device; anything else by value."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    try:
        hash(x)
    except TypeError:
        raise TypeError(
            f"a non-tensor argument of a program on the card keys its cache "
            f"and must be hashable; got {type(x).__name__}") from None
    return (type(x), x)


def _step_leaves(leaves, i):
    return [x[i] if isinstance(x, torch.Tensor) else x for x in leaves]


def _check_outputs(outputs):
    spec = _structure(outputs[0], _output_leaf)
    if any(_structure(o, _output_leaf) != spec for o in outputs[1:]):
        raise ValueError("the body returned differently structured outputs "
                         "from one inner step to the next")


def _stack(outputs):
    """Per-step output nests -> one nest of ``[k, ...]`` tensors."""
    _check_outputs(outputs)
    per_step = [_tree(o)[0] for o in outputs]
    _, rebuild = _tree(outputs[0])
    return rebuild([None if col[0] is None else
                    torch.stack([c.detach() for c in col])
                    for col in zip(*per_step)])


class _GraphProgram:
    """One unit of the body (``n`` inner steps) captured into a CUDA graph,
    with the static input buffers it reads and the outputs it writes."""

    def __init__(self, run_step, unit_leaves, n, stacked, device):
        self.run_step = run_step  # (i, step leaves) -> the body's output
        self.n = n
        self.stacked = stacked  # tensor inputs carry a leading [n] dim
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.consts = [None if isinstance(x, torch.Tensor) else x
                       for x in unit_leaves]
        self.inputs = None  # allocated on the program's stream
        self.graph = None
        self.outputs = None  # per inner step, the output leaves

    def _call(self):
        leaves = [c if buf is None else buf
                  for buf, c in zip(self.inputs, self.consts)]
        return [self.run_step(i, _step_leaves(leaves, i) if self.stacked
                              else leaves) for i in range(self.n)]

    def _load(self, unit_leaves):
        for buf, x in zip(self.inputs, unit_leaves):
            if buf is not None:
                buf.copy_(x)

    def warm_up_and_capture(self, unit_leaves):
        """Run the unit once eagerly from the static buffers (real steps),
        then capture one unit; returns the eager unit's output leaves."""
        self.inputs = [torch.empty_like(x) if isinstance(x, torch.Tensor)
                       else None for x in unit_leaves]
        self._load(unit_leaves)
        out = self._call()
        _check_outputs(out)
        spec = _structure(out[0], _output_leaf)
        self.graph = torch.cuda.CUDAGraph()
        _random.register_with_graph(self.graph, self.device)
        # A graph that Python's collector frees destroys itself, which
        # invalidates a capture under way: collect what is dead now (a
        # dropped program is a reference cycle) and not during the capture.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = _tracing.now_ns()
        try:
            # no op observer runs under a capture (a host read breaks it)
            with _dispatch.static_scope(), torch.cuda.graph(
                    self.graph, stream=self.stream):
                captured = self._call()
        finally:
            if collecting:
                gc.enable()
        _tracing.record_compile("capture", t0, _tracing.now_ns(),
                                steps=self.n)
        if _structure(captured[0], _output_leaf) != spec:
            raise RuntimeError("the captured step returned other outputs "
                               "than its eager warm-up")
        _check_outputs(captured)
        self.outputs = [_tree(o)[0] for o in captured]
        self.out_rebuild = _tree(captured[0])[1]
        return [_tree(o)[0] for o in out]

    def memory_stats(self):
        """The captured unit's device memory, in the reference's kinds:
        ``argument_bytes`` (its static input buffers), ``output_bytes``
        (the outputs it writes), ``temp_bytes`` (the segments of the
        graph's memory pool, beyond the outputs), ``alias_bytes`` and
        ``generated_code_bytes`` (0: no donation, no generated code) and
        ``peak_bytes``. State (parameters, moments) is updated in place
        and is the state ledger's (``observability.memory``)."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts
                       if isinstance(t, torch.Tensor))
        out_bytes = nbytes(t for step in self.outputs for t in step)
        # the graph's private pool: the allocator's segments that carry
        # its id (read without resetting the device's peak counter, which
        # callers measure by; the reserved total around a capture was seen
        # to grow by far less than the pool holds)
        pool = tuple(self.graph.pool())
        pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool)
        stats = {"argument_bytes": nbytes(self.inputs),
                 "output_bytes": out_bytes,
                 "temp_bytes": max(pool_bytes - out_bytes, 0),
                 "alias_bytes": 0, "generated_code_bytes": 0,
                 "host_offload_bytes": 0}
        stats["peak_bytes"] = _memory.peak_bytes(stats)
        return stats

    def replay(self, unit_leaves):
        self._load(unit_leaves)
        self.graph.replay()
        return self.outputs


class StaticFunction:
    """``fn`` as one program (``scan_steps=None``) or as the k-step program
    over ``[k, ...]``-stacked arguments; programs on the card are cached by
    signature."""

    def __init__(self, fn, input_spec=None, donate_state=True,
                 scan_steps=None, dp_axis=None, accumulate_steps=None,
                 xla_flags=None):
        if scan_steps is not None and int(scan_steps) < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        self._scan_steps = int(scan_steps) if scan_steps is not None else None
        if dp_axis is not None and self._scan_steps is None:
            raise ValueError(
                "dp_axis is an option of the scan step program; pass "
                "scan_steps=k (k=1 runs a single-step program)")
        self._dp_axis = dp_axis
        self._accumulate_steps = None
        if accumulate_steps is not None:
            a = int(accumulate_steps)
            if self._scan_steps is None:
                raise ValueError(
                    "accumulate_steps is an option of the scan step "
                    "program; pass scan_steps=k")
            if a < 1:
                raise ValueError(
                    f"accumulate_steps must be >= 1, got {accumulate_steps}")
            if a > 1 and self._scan_steps % a:
                raise ValueError(
                    f"scan_steps={self._scan_steps} must be a multiple of "
                    f"accumulate_steps={a} (whole accumulation windows)")
            self._accumulate_steps = a if a > 1 else None
        if input_spec is not None:
            raise NotImplementedError("input_spec is not ported")
        self._fn = fn
        self._programs = {}
        functools.update_wrapper(self, fn)

    def _run_step(self, i, leaves, rebuild):
        """Inner step ``i`` of a unit, in its dp and accumulation context."""
        a = self._accumulate_steps
        axis = self._dp_axis
        with parallel_env.dp_axis_ctx(axis), parallel_env.program_ctx(
                self), parallel_env.accum_ctx(
                "fire" if a is None or i == a - 1 else "accum", a or 1):
            if axis is not None:
                _run_hooks("step", axis, self)
            args, kwargs = rebuild(leaves)
            return self._fn(*args, **kwargs)

    def _rank_slice(self, leaves):
        """This rank's ``B/dp`` rows of dim 1 of every stacked input, where
        all of them agree on a dim 1 that dp divides; else all whole."""
        mesh = parallel_env.current_mesh()
        axis = self._dp_axis
        if mesh is None or axis not in mesh.axis_names:
            raise RuntimeError(f"dp_axis={axis!r} needs an active mesh with "
                               f"that axis (distributed.set_mesh)")
        dp = parallel_env.axis_degree(mesh, axis)
        group = parallel_env.axis_group(mesh, axis)
        rank = torch.distributed.get_rank(group)
        dim1 = {x.shape[1] for x in leaves
                if isinstance(x, torch.Tensor) and x.dim() >= 2}
        if len(dim1) != 1 or next(iter(dim1)) % dp:
            if dp > 1:
                warnings.warn(
                    f"dp_axis={axis!r}: stacked inputs disagree on a "
                    f"microbatch dim (dim-1 sizes {sorted(dim1)}) or dp={dp} "
                    "does not divide it; all inputs stay whole on every rank")
            return leaves, dp, group
        b = next(iter(dim1)) // dp
        return [x[:, rank * b:(rank + 1) * b]
                if isinstance(x, torch.Tensor) and x.dim() >= 2 else x
                for x in leaves], dp, group

    def __call__(self, *args, **kwargs):
        leaves, rebuild = _tree((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not tensors:
            raise ValueError("a static program takes at least one tensor "
                             "argument, whose device it runs on")
        devices = {t.device for t in tensors}
        if len(devices) > 1:
            raise ValueError(f"the tensor arguments are on several devices: "
                             f"{sorted(map(str, devices))}")
        k = self._scan_steps
        if k is not None:
            for t in tensors:
                if t.dim() == 0 or t.shape[0] != k:
                    raise ValueError(
                        f"scan_steps={k}: every dynamic input must be "
                        f"stacked [k, ...]; got shape {tuple(t.shape)}")
        device = devices.pop()
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        dp = group = None
        if self._dp_axis is not None:
            leaves, dp, group = self._rank_slice(leaves)

        def run_step(i, step_leaves):
            return self._run_step(i, step_leaves, rebuild)

        if device.type == "cuda":
            key = _structure(leaves, _argument_leaf)
            out = self._run_graph(device, key, leaves, run_step)
        elif k is None:
            return run_step(0, leaves)
        else:
            a = self._accumulate_steps or 1
            if self._dp_axis is not None:
                _run_hooks("call_begin", self._dp_axis, self)
            out = _stack([run_step(i % a, _step_leaves(leaves, i))
                          for i in range(k)])
            if self._dp_axis is not None:
                _run_hooks("call_end", self._dp_axis, self)
        if self._dp_axis is not None:
            out = self._mean_over_ranks(out, dp, group)
        return out

    def _memory_entries(self):
        """``(label, program)`` per captured program, labelled
        ``<fn>#<i>:<kind>`` as the reference labels its entries."""
        name = getattr(self, "__name__", "fn")
        kind = "scan" if self._scan_steps is not None else "unrolled"
        return [(f"{name}#{i}:{kind}", prog)
                for i, prog in enumerate(self._programs.values())
                if prog.outputs is not None]

    def memory_stats(self):
        """``{label: stats}`` of each captured program (the reference's
        per-entry attribution; :meth:`_GraphProgram.memory_stats`)."""
        out = {label: prog.memory_stats()
               for label, prog in self._memory_entries()}
        if not out:
            raise RuntimeError(
                "no captured program yet; call the step once on the card "
                "before asking for its memory attribution")
        return out

    def export_memory_stats(self):
        """:meth:`memory_stats`, each entry recorded in the program-memory
        registry (``observability.memory``) and exported as
        ``program_hbm_bytes{entry=,kind=}`` gauges; returns the stats."""
        stats = {label: _memory.record_program_memory(label,
                                                      prog.memory_stats())
                 for label, prog in self._memory_entries()}
        if not stats:
            raise RuntimeError(
                "no captured program yet; call the step once on the card "
                "before asking for its memory attribution")
        return stats

    @staticmethod
    def _mean_over_ranks(out, dp, group):
        leaves, rebuild = _tree(out)
        for t in leaves:
            if t is not None and t.is_floating_point():
                _collective.all_reduce(t, group=group)
                t.div_(dp)
        return rebuild(leaves)

    def _run_graph(self, device, key, leaves, run_step):
        k = self._scan_steps
        a = self._accumulate_steps or 1
        units = k // a if k is not None else 1
        unit_of = ((lambda u: [x[u * a:(u + 1) * a]
                               if isinstance(x, torch.Tensor) else x
                               for x in leaves]) if k is not None
                   else (lambda u: leaves))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _GraphProgram(
                run_step, unit_of(0), a, k is not None, device)
        current = torch.cuda.current_stream(device)
        prog.stream.wait_stream(current)
        stacked = None
        try:
            with torch.cuda.device(device), torch.cuda.stream(prog.stream):
                for x in leaves:
                    if isinstance(x, torch.Tensor):
                        x.record_stream(prog.stream)
                if self._dp_axis is not None:
                    _run_hooks("call_begin", self._dp_axis, self)
                for u in range(units):
                    if prog.graph is None:
                        outs = prog.warm_up_and_capture(unit_of(u))
                    else:
                        outs = prog.replay(unit_of(u))
                    if k is None:
                        stacked = [None if o is None else o.detach().clone()
                                   for o in outs[0]]
                        continue
                    if stacked is None:
                        stacked = [None if o is None else o.new_empty(
                            (k, *o.shape)) for o in outs[0]]
                    for j, out in enumerate(outs):
                        for buf, o in zip(stacked, out):
                            if buf is not None:
                                buf[u * a + j].copy_(o.detach())
                if self._dp_axis is not None:
                    _run_hooks("call_end", self._dp_axis, self)
        except BaseException:
            if prog.graph is None or prog.outputs is None:
                self._programs.pop(key, None)  # never replay half a capture
            raise
        current.wait_stream(prog.stream)
        for t in stacked:
            if t is not None:
                t.record_stream(current)
        return prog.out_rebuild(stacked)


def to_static(function=None, input_spec=None, build_strategy=None,
              scan_steps=None, dp_axis=None, accumulate_steps=None,
              xla_flags=None, **kwargs):
    """Decorator or wrapper, ``@to_static`` or ``to_static(fn, ...)``:
    ``fn`` as one program, or with ``scan_steps=k`` as the k-step program
    over ``[k, ...]``-stacked arguments with ``[k, ...]``-stacked outputs,
    optionally one rank of a data-parallel group (``dp_axis``) with
    accumulation windows (``accumulate_steps``). On the card the program
    is a CUDA graph; on the CPU a loop. ``xla_flags`` and the other
    keywords of the reference's ``StaticFunction`` (``donate_state``) have
    no effect on CUDA."""
    if function is None:
        return lambda fn: to_static(fn, input_spec=input_spec,
                                    build_strategy=build_strategy,
                                    scan_steps=scan_steps, dp_axis=dp_axis,
                                    accumulate_steps=accumulate_steps,
                                    xla_flags=xla_flags, **kwargs)
    if isinstance(function, StaticFunction):
        return function
    return StaticFunction(function, input_spec=input_spec,
                          scan_steps=scan_steps, dp_axis=dp_axis,
                          accumulate_steps=accumulate_steps,
                          xla_flags=xla_flags, **kwargs)


class InputSpec:
    """Shape/dtype declaration (reference: ``paddle.static.InputSpec``):
    ``None`` (or -1) marks a dynamic dim, axis 0 the batch."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"
