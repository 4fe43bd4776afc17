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

Where the program runs is where its tensor arguments are:

- On the CPU it is a plain loop over the body, so its results are bitwise
  those of the same eager calls.
- On the card it is a CUDA graph (``torch.cuda.CUDAGraph``). The first call
  for a signature (the shapes and dtypes of the tensors and the values of
  the other arguments, as the reference keys its compile cache) runs the
  body once eagerly on the program's stream from the program's static
  input buffers: that is inner step 0, and it creates whatever the body
  builds lazily (kernel attributes, cuBLAS workspaces) before any capture.
  Then one step of the body is captured from the same buffers, and every
  further step copies its microbatch into the buffers and replays the
  graph. The graph holds one step, not k: its capture time and its memory
  pool do not grow with k, as the reference's scan traces its body once.
  The per-step outputs are copied into ``[k, ...]`` device tensors; the
  host reads nothing.

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
  replay runs no Python: launches under the program are counted by the
  profiler.

A capture or replay that fails raises; the program never runs eagerly in
its place. Not ported: ``dp_axis`` and ``accumulate_steps`` (ZeRO data
parallelism, ROADMAP item 10), the AST fallback, ``input_spec`` and
per-program compiler flags.
"""
import functools

import torch

from ..core import random as _random

_ZERO = ("is an option of the ZeRO data-parallel step program, which is not "
         "ported yet (ROADMAP item 10)")


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


def _stack(outputs):
    """Per-step output nests -> one nest of ``[k, ...]`` tensors."""
    spec = _structure(outputs[0], _output_leaf)
    if any(_structure(o, _output_leaf) != spec for o in outputs[1:]):
        raise ValueError("the body returned differently structured outputs "
                         "from one inner step to the next")
    per_step = [_tree(o)[0] for o in outputs]
    _, rebuild = _tree(outputs[0])
    return rebuild([None if col[0] is None else
                    torch.stack([c.detach() for c in col])
                    for col in zip(*per_step)])


class _GraphProgram:
    """One step of the body captured into a CUDA graph, with the static
    input buffers it reads and the output tensors it writes."""

    def __init__(self, fn, rebuild, step_leaves, device):
        self.fn = fn
        self.rebuild = rebuild
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.consts = [None if isinstance(x, torch.Tensor) else x
                       for x in step_leaves]
        self.inputs = None  # allocated on the program's stream
        self.graph = None
        self.outputs = None

    def _call(self):
        leaves = [c if buf is None else buf
                  for buf, c in zip(self.inputs, self.consts)]
        args, kwargs = self.rebuild(leaves)
        return self.fn(*args, **kwargs)

    def _load(self, step_leaves):
        for buf, x in zip(self.inputs, step_leaves):
            if buf is not None:
                buf.copy_(x)

    def warm_up_and_capture(self, step_leaves):
        """Run the body once eagerly from the static buffers (a real step),
        then capture one step; returns the eager step's output leaves."""
        self.inputs = [torch.empty_like(x) if isinstance(x, torch.Tensor)
                       else None for x in step_leaves]
        self._load(step_leaves)
        out = self._call()
        spec = _structure(out, _output_leaf)
        self.graph = torch.cuda.CUDAGraph()
        _random.register_with_graph(self.graph, self.device)
        with torch.cuda.graph(self.graph, stream=self.stream):
            captured = self._call()
        if _structure(captured, _output_leaf) != spec:
            raise RuntimeError("the captured step returned other outputs "
                               "than its eager warm-up")
        self.outputs, self.out_rebuild = _tree(captured)
        return _tree(out)[0]

    def replay(self, step_leaves):
        self._load(step_leaves)
        self.graph.replay()
        return self.outputs


class StaticFunction:
    """``fn`` as one program (``scan_steps=None``) or as the k-step program
    over ``[k, ...]``-stacked arguments; programs on the card are cached by
    signature."""

    def __init__(self, fn, input_spec=None, scan_steps=None, dp_axis=None,
                 accumulate_steps=None):
        if scan_steps is not None and int(scan_steps) < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        if dp_axis is not None:
            raise NotImplementedError(f"dp_axis {_ZERO}")
        if accumulate_steps is not None:
            raise NotImplementedError(f"accumulate_steps {_ZERO}")
        if input_spec is not None:
            raise NotImplementedError("input_spec is not ported")
        self._fn = fn
        self._scan_steps = int(scan_steps) if scan_steps is not None else None
        self._programs = {}
        functools.update_wrapper(self, fn)

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
        if device.type == "cuda":
            key = _structure((args, kwargs), _argument_leaf)
            return self._run_graph(device, key, leaves, rebuild)
        if device.type != "cpu":
            raise ValueError(f"unsupported device {device}")

        def call(step):
            a, kw = rebuild(step)
            return self._fn(*a, **kw)

        if k is None:
            return call(leaves)
        return _stack([call(_step_leaves(leaves, i)) for i in range(k)])

    def _run_graph(self, device, key, leaves, rebuild):
        k = self._scan_steps
        steps = k or 1
        step_of = ((lambda i: _step_leaves(leaves, i)) if k is not None
                   else (lambda i: leaves))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _GraphProgram(
                self._fn, rebuild, step_of(0), device)
        current = torch.cuda.current_stream(device)
        prog.stream.wait_stream(current)
        stacked = None
        try:
            with torch.cuda.device(device), torch.cuda.stream(prog.stream):
                for x in leaves:
                    if isinstance(x, torch.Tensor):
                        x.record_stream(prog.stream)
                for i in range(steps):
                    if prog.graph is None:
                        out = prog.warm_up_and_capture(step_of(i))
                    else:
                        out = prog.replay(step_of(i))
                    if k is None:
                        stacked = [None if o is None else o.detach().clone()
                                   for o in out]
                        continue
                    if stacked is None:
                        stacked = [None if o is None else o.new_empty(
                            (k, *o.shape)) for o in out]
                    for buf, o in zip(stacked, out):
                        if buf is not None:
                            buf[i].copy_(o.detach())
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
              scan_steps=None, dp_axis=None, accumulate_steps=None):
    """Decorator or wrapper, ``@to_static`` or ``to_static(fn, ...)``:
    ``fn`` as one program, or with ``scan_steps=k`` as the k-step program
    over ``[k, ...]``-stacked arguments with ``[k, ...]``-stacked outputs.
    On the card the program is a CUDA graph; on the CPU a loop."""
    if function is None:
        return lambda fn: to_static(fn, input_spec=input_spec,
                                    build_strategy=build_strategy,
                                    scan_steps=scan_steps, dp_axis=dp_axis,
                                    accumulate_steps=accumulate_steps)
    if isinstance(function, StaticFunction):
        return function
    return StaticFunction(function, input_spec=input_spec,
                          scan_steps=scan_steps, dp_axis=dp_axis,
                          accumulate_steps=accumulate_steps)
