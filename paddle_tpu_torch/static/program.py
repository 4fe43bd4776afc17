"""The static graph: ``Program``, ``Executor``, ``append_backward`` and
``gradients`` (counterpart: ``paddle_tpu/static/program.py``).

A Program is a list of recorded ops, each a callable with its arguments'
variable slots. Recording starts with :func:`program_guard`, which pushes
a ``TorchFunctionMode`` on the calling thread (the seam of
``core.dispatch``'s op observers): from then on every torch call that
reads a program variable (a feed, or the output of a recorded op) or a
``Parameter`` is run once on the build's placeholder values, for their
shapes, and recorded. The port's own seams record as one opaque op each:
a ``boundary`` functional or op (``nn.functional``, ``ops``) under its
``op_name``, and ``scaled_dot_product_attention`` with the flash kernels'
``autograd.Function`` inside it, so the replay's backward is the kernels'
backward. Nothing inside a recorded op is recorded. So a Program keeps
the reference's functional granularity (``embedding``, ``add``,
``layer_norm``, ``linear``, ``reshape``, ...); a plain torch call is
recorded under torch's own name (``add``, ``matmul``, ``view``,
``unbind``), which is where the names of the two packages differ.

What the build does not do:

- Parameters are created and initialised eagerly (an in-place write to a
  ``Parameter`` and ``torch.nn.init`` are not ops).
- A recorded op that writes a tensor that is no program variable (the
  running statistics of ``batch_norm``, the power-iteration vectors of
  ``SpectralNorm``) writes it at build and has it put back at once: the
  write happens at every replay, on the live buffer, and the op keeps the
  slots it writes (``mutates``), which ``prune`` follows.
- A recorded op's random draws at build are taken back (the generators'
  states are restored), so building a Program moves no random stream.
- An integer read off a shape at build (``x.shape[0]``) is a constant of
  the Program, as in the reference: a feed dimension given as ``None``
  is built as 1.
- The build records no gradients (its values carry no autograd graph).

The :class:`Executor` replays the op list as a function of the feeds and
the live parameters: inference (no autograd), training (replay,
``backward``, ``opt.step()``, ``opt.clear_grad()``: the program's
optimizer updates the live parameters and its state in place), or the
``@GRAD`` fetches (``torch.autograd.grad`` of the summed targets). Each is
one ``jit.to_static`` program per cache key (the mode, the feeds' names,
shapes and dtypes, the fetched slots): on the card one CUDA graph, captured
after an eager warm-up step, every later run a replay; on the CPU a plain
call. A capture that fails raises. ``return_numpy=True`` costs one
device-to-host copy per fetch.
"""
import inspect
import threading
import weakref
import contextlib
from contextlib import contextmanager

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..core import dispatch as _dispatch
from ..core import random as _random
from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor, host_array, unwrap, wrap

__all__ = ["Program", "program_guard", "default_main_program",
           "default_startup_program", "data", "Executor", "global_scope",
           "name_scope", "append_backward", "gradients", "Block",
           "Operator"]

# torch calls that read metadata, host values or autograd hooks: never ops
_NOT_OPS = frozenset(_dispatch._NOT_OPS | {
    "register_post_accumulate_grad_hook", "is_inference"})
# property reads that compute (other properties are metadata)
_OP_PROPERTIES = frozenset({"T", "mT", "H", "mH", "real", "imag"})
_INPLACE_DUNDERS = frozenset({
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__",
    "__ifloordiv__", "__imod__", "__ipow__", "__iand__", "__ior__",
    "__ixor__", "__ilshift__", "__irshift__", "__imatmul__"})


def _is_inplace(name):
    return name in _INPLACE_DUNDERS or (
        name.endswith("_") and not name.startswith("__"))


class _Slot:
    __slots__ = ("idx",)

    def __init__(self, idx):
        self.idx = idx

    def __repr__(self):
        return f"slot_{self.idx}"


class _OpRecord:
    """One recorded op: ``fn`` over ``args``/``kwargs`` (nests whose
    tensors are ``_Slot``s), writing ``out_slots`` in the flattened order
    of its outputs. ``eval_fn`` is the op in evaluation mode (dropout off,
    batch norm on its running statistics), which ``clone(for_test=True)``
    takes; ``mutates`` the non-variable slots the op writes in place."""
    __slots__ = ("fn", "args", "kwargs", "out_slots", "name", "eval_fn",
                 "mutates")

    def __init__(self, fn, args, kwargs, out_slots, name, eval_fn=None,
                 mutates=()):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.out_slots = out_slots
        self.name = name
        self.eval_fn = eval_fn
        self.mutates = tuple(mutates)

    def in_slots(self):
        out = []
        _collect_slots(self.args, out)
        _collect_slots(self.kwargs, out)
        return out

    def replace(self, **kw):
        fields = {k: getattr(self, k) for k in self.__slots__}
        fields.update(kw)
        return _OpRecord(**fields)


def _collect_slots(tree, out):
    if isinstance(tree, _Slot):
        out.append(tree.idx)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _collect_slots(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect_slots(v, out)


def _resolve(tree, env):
    if isinstance(tree, _Slot):
        return env[tree.idx]
    if isinstance(tree, (tuple, list)) and type(tree) in (tuple, list):
        return type(tree)(_resolve(v, env) for v in tree)
    if isinstance(tree, dict):
        return {k: _resolve(v, env) for k, v in tree.items()}
    return tree


def _flat_tensors(tree, out):
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flat_tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _flat_tensors(v, out)
    return out


def _eval_variant(fn, args, kwargs):
    """``fn`` with ``training=False`` where it takes a ``training`` flag
    that this call leaves True (dropout, batch norm, attention dropout);
    None where it takes none or the flag is False already."""
    try:
        sig = inspect.signature(fn)
        bound = sig.bind(*args, **kwargs)
    except (TypeError, ValueError):
        return None
    if "training" not in sig.parameters:
        return None
    bound.apply_defaults()
    if not bound.arguments.get("training"):
        return None

    def evaluate(*a, **k):
        b = sig.bind(*a, **k)
        b.arguments["training"] = False
        return fn(*b.args, **b.kwargs)
    evaluate.__name__ = getattr(fn, "__name__", "op")
    return evaluate


def _under_amp(fn):
    """``fn`` replayed under the ``amp.auto_cast`` state it was recorded
    in (``amp_guard`` around a build casts at every replay)."""
    from ..amp.auto_cast import get_amp_state
    amp = get_amp_state()
    if not amp.enabled:
        return fn
    state = (amp.enabled, amp.dtype, amp.level, set(amp.custom_white),
             set(amp.custom_black))

    def run(*args, **kwargs):
        from ..recompute import _amp_state
        with _amp_state(state):
            return fn(*args, **kwargs)
    run.__name__ = getattr(fn, "__name__", "op")
    return run


class _RngGuard:
    """Takes back the random draws of an op run at build."""

    def __enter__(self):
        self.cpu = torch.get_rng_state()
        self.cuda = (torch.cuda.get_rng_state_all()
                     if torch.cuda.is_initialized() else None)
        self.pkg = {d: g.get_state() for d, g in _random.generators().items()}
        return self

    def __exit__(self, *exc):
        torch.set_rng_state(self.cpu)
        if self.cuda is not None:
            torch.cuda.set_rng_state_all(self.cuda)
        gens = _random.generators()
        for d, g in gens.items():
            if d in self.pkg:
                g.set_state(self.pkg[d])
            else:  # made by the op: made afresh from the seed next time
                _random._state["generators"].pop(d, None)
        return False


class Program:
    """A recorded op list over variable slots (counterpart of the
    reference's ``Program``; ``framework.py`` Program:4017)."""

    NOT_RECORDED = object()

    def __init__(self):
        self.ops = []
        self._tensor_slot = {}  # id(tensor) -> slot
        self._slot_count = 0
        self._keepalive = []  # feeds, parameters and constants
        self.feed_vars = {}  # name -> (slot, shape, dtype)
        self._pruned_feeds = set()  # feed names prune() sliced away
        self.params = {}  # slot -> parameter, buffer or constant
        self._produced = set()  # slots written by a recorded op
        self._optimizer = None
        self._loss_slot = None
        self._ps_ctx = None  # set by DistributeTranspiler.transpile()
        self._compiled = {}
        self.random_seed = None
        # a control-flow block: every op that reads a tensor is recorded
        # (the tensors from outside are its inputs), and, when ``_live``
        # (recorded while it runs under a capture), its ops act for real
        self._record_all = False
        self._live = False

    # -- recording --------------------------------------------------------
    def _new_slot(self, t, strong):
        s = self._slot_count
        self._slot_count += 1
        self._bind(t, s, strong)
        return s

    def _bind(self, t, s, strong):
        key = id(t)
        self._tensor_slot[key] = s
        if strong:
            self._keepalive.append(t)
        else:  # a variable: forget its id when the tensor dies
            weakref.finalize(t, _forget, weakref.ref(self), key, s)

    def _slot_of(self, t, create=True):
        s = self._tensor_slot.get(id(t))
        if s is None and create:
            s = self._new_slot(t, strong=True)
            self.params[s] = t
        return s

    def _is_var(self, t):
        s = self._tensor_slot.get(id(t))
        return s is not None and s not in self.params

    def _alias(self, x, out):
        """``out`` is another Python object over variable ``x``."""
        s = self._tensor_slot.get(id(x))
        if s is not None and s not in self.params:
            self._bind(out, s, strong=False)

    def _template(self, tree, consts):
        if isinstance(tree, torch.Tensor):
            s = self._tensor_slot.get(id(tree))
            if s is None:
                s = self._slot_of(tree)
            if s in self.params and not isinstance(tree, torch.nn.Parameter):
                consts.append((s, tree))
            return _Slot(s)
        if isinstance(tree, (tuple, list)) and type(tree) in (tuple, list):
            return type(tree)(self._template(v, consts) for v in tree)
        if isinstance(tree, dict):
            return {k: self._template(v, consts) for k, v in tree.items()}
        return tree

    def _record(self, fn, args, kwargs, name, plain_body=False):
        """Record ``fn(*args, **kwargs)`` as op ``name`` and return its
        build outputs, or ``NOT_RECORDED`` when it reads no program
        variable and no parameter (the caller then runs it as a
        constant). ``plain_body``: ``fn`` is a boundary body over plain
        tensors, whose results come back as ``Tensor``s."""
        tensors = _flat_tensors((args, kwargs), [])
        has_var = any(self._is_var(t) for t in tensors)
        if self._record_all:
            if not tensors:
                return self.NOT_RECORDED
        elif _is_inplace(name) and not plain_body:
            target = args[0] if args else None
            if not has_var or (isinstance(target, torch.nn.Parameter)
                               and not self._is_var(target)):
                return self.NOT_RECORDED
        elif not has_var and not any(isinstance(t, torch.nn.Parameter)
                                     for t in tensors):
            return self.NOT_RECORDED
        consts = []
        targs = self._template(tuple(args), consts)
        tkwargs = self._template(dict(kwargs), consts)
        call_args, call_kwargs = ((unwrap(args), unwrap(kwargs)) if plain_body
                                  else (args, kwargs))
        live = self._live
        saved = [] if live else [(s, t, t._version, t.detach().clone())
                                 for s, t in consts]
        params = [] if live else [(t, t._version) for t in tensors
                                  if isinstance(t, torch.nn.Parameter)]
        # the build computes shapes, not gradients: an autograd graph kept
        # alive by the build's tensors would pin the parameters'
        # AccumulateGrad nodes to the build's stream
        with _dispatch.suspend_recording(), (
                contextlib.nullcontext() if live else _RngGuard()), (
                contextlib.nullcontext() if live else torch.no_grad()):
            out = fn(*call_args, **call_kwargs)
        mutates = []
        with torch.no_grad():
            for s, t, version, before in saved:
                if t._version != version:
                    t.copy_(before)
                    mutates.append(s)
        for p, version in params:
            if p._version != version:
                raise RuntimeError(
                    f"the recorded op {name!r} wrote a parameter while the "
                    f"program was built; only buffers may be written by a "
                    f"recorded op")
        replay_fn = _under_amp(fn)
        outs = _flat_tensors(out, [])
        out_slots = []
        for o in outs:
            s = self._tensor_slot.get(id(o))
            if s is None:
                s = self._new_slot(o, strong=False)
            out_slots.append(s)
        self._produced.update(s for s in out_slots if s not in self.params)
        eval_fn = _eval_variant(fn, call_args, call_kwargs)
        self.ops.append(_OpRecord(
            replay_fn, targs, tkwargs, out_slots, name,
            eval_fn=None if eval_fn is None else _under_amp(eval_fn),
            mutates=sorted(set(mutates))))
        if plain_body:
            out = wrap(out) if _has_wrapped(args, kwargs) else out
            for o, s in zip(_flat_tensors(out, []), out_slots):
                if id(o) not in self._tensor_slot:
                    self._bind(o, s, strong=False)
        return out

    def record(self, fn, args, kwargs, op_name):
        """Record ``fn`` (over plain tensors) as one op ``op_name`` of this
        program and return its outputs on the build's values."""
        out = self._record(fn, tuple(args), dict(kwargs), op_name,
                           plain_body=True)
        if out is self.NOT_RECORDED:
            with _dispatch.suspend_recording():
                return fn(*unwrap(tuple(args)), **unwrap(dict(kwargs)))
        return out

    def _record_data(self, t):
        return self._new_slot(t, strong=True)

    # -- replay -----------------------------------------------------------
    def _replay(self, env, post_write=None, ops=None):
        """Run the op records over ``env`` (slot -> tensor). ``post_write``
        maps a slot to ``fn(value)``, applied right after its op writes it
        (an intermediate taken as an independent input, or held
        constant)."""
        with _dispatch.suspend_recording():
            for op in (self.ops if ops is None else ops):
                out = op.fn(*_resolve(op.args, env),
                            **_resolve(op.kwargs, env))
                for s, o in zip(op.out_slots, _flat_tensors(out, [])):
                    if post_write is not None and s in post_write:
                        o = post_write[s](o)
                    env[s] = o

    def _env(self):
        return {s: unwrap(t) if type(t) is Tensor else t
                for s, t in self.params.items()}

    def _pure(self, feed_slots, fetch_slots):
        """``run(feed_values) -> fetch values`` over the program's
        parameters and constants."""
        params = self._env()

        def run(feed_vals):
            env = dict(params)
            env.update(zip(feed_slots, feed_vals))
            self._replay(env)
            return [env[s] for s in fetch_slots]
        return run

    def as_layer(self, feed_vars, fetch_vars):
        """The program as a Layer whose forward replays it (fed in
        ``feed_vars``' order) and returns ``fetch_vars``; the program's
        parameters and constants are its parameters and buffers."""
        from ..nn.layer.layers import Layer
        prog = self
        feed_slots = [prog.feed_vars[v.name][0] for v in feed_vars]
        fetch_slots = [prog._slot_of(v, create=False) for v in fetch_vars]
        slots = sorted(prog.params)

        class _ProgramLayer(Layer):
            def __init__(self):
                super().__init__()
                for s in slots:
                    t = prog.params[s]
                    if isinstance(t, torch.nn.Parameter):
                        self.register_parameter(f"slot_{s}", t)
                    else:
                        self.register_buffer(f"slot_{s}", unwrap(t))

            def forward(self, *inputs):
                env = {s: getattr(self, f"slot_{s}") for s in slots}
                env.update(zip(feed_slots, inputs))
                prog._replay(env)
                outs = tuple(env[s] for s in fetch_slots)
                return outs[0] if len(outs) == 1 else outs

        return _ProgramLayer()

    # -- introspection ----------------------------------------------------
    def global_block(self):
        """The single block (``framework.py`` Block:2522): control flow
        records as one op whose branches are op lists of their own."""
        return Block(self)

    @property
    def blocks(self):
        return [Block(self)]

    def num_blocks(self):
        return 1

    def op_names(self):
        return [op.name for op in self.ops]

    def _shallow(self, ops):
        """A new Program over ``ops`` sharing this one's slots, variables
        and parameters (and its training identity)."""
        p = Program()
        p.ops = ops
        p._tensor_slot = self._tensor_slot
        p._slot_count = self._slot_count
        p._keepalive = self._keepalive
        p.feed_vars = self.feed_vars
        p._pruned_feeds = set(self._pruned_feeds)
        p.params = self.params
        p._produced = self._produced
        p.random_seed = self.random_seed
        p._optimizer = self._optimizer
        p._loss_slot = self._loss_slot
        p._ps_ctx = self._ps_ctx
        return p

    def clone(self, for_test=False):
        """``for_test=True``: every op in its evaluation variant (dropout
        off, batch norm on its running statistics, no statistics
        written) and no optimizer; the slots and parameters are shared.
        ``for_test=False`` returns the program itself, as the reference."""
        if not for_test:
            return self
        p = self._shallow([op.replace(fn=op.eval_fn or op.fn, eval_fn=None,
                                      mutates=() if op.eval_fn else
                                      op.mutates) for op in self.ops])
        p._optimizer = None
        p._loss_slot = None
        p._ps_ctx = None
        return p


def _has_wrapped(args, kwargs):
    return any(type(t) is Tensor for t in _flat_tensors((args, kwargs), []))


def _forget(prog_ref, key, s):
    """A variable died: its id may name another tensor now. (The program
    is held weakly: a registry entry must not keep it alive.)"""
    prog = prog_ref()
    if prog is not None and prog._tensor_slot.get(key) == s:
        del prog._tensor_slot[key]


class _RecordMode(TorchFunctionMode):
    """Every torch call of the guarded thread that reads a program
    variable or a parameter, recorded into the thread's Program."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prog = _dispatch.recorder()
        if prog is None:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", None) or str(func)
        if name == "__get__":
            name = getattr(getattr(func, "__self__", None), "__name__", "")
            if name not in _OP_PROPERTIES:
                return func(*args, **kwargs)
        elif name in _NOT_OPS or getattr(func, "__module__",
                                         "") == "torch.nn.init":
            return func(*args, **kwargs)
        elif name == "__iter__":  # iterating a variable unbinds it
            out = prog._record(torch.Tensor.unbind, args[:1], {}, "unbind")
            return iter(func(*args) if out is prog.NOT_RECORDED else out)
        out = prog._record(func, args, kwargs, name)
        if out is prog.NOT_RECORDED:
            return func(*args, **kwargs)
        return out


_default_main = Program()
_default_startup = Program()
_tls = threading.local()


def default_main_program():
    return getattr(_tls, "main", None) or _default_main


def default_startup_program():
    return _default_startup


@contextmanager
def program_guard(main_program, startup_program=None):
    """Record into ``main_program`` on this thread (``startup_program``
    is accepted: parameters are initialised eagerly)."""
    prev = getattr(_tls, "main", None)
    prev_rec = _dispatch._rec.program
    _tls.main = main_program
    _dispatch._rec.program = main_program
    _dispatch._rec.stack.append(main_program)
    _dispatch._RECORDING[0] += 1
    mode = _RecordMode()
    mode.__enter__()
    try:
        yield
    finally:
        mode.__exit__(None, None, None)
        _dispatch._RECORDING[0] -= 1
        _dispatch._rec.stack.pop()
        _dispatch._rec.program = prev_rec
        _tls.main = prev


@contextmanager
def recording_into(program):
    """Record this thread's ops into ``program`` (a control-flow block)
    within the block, then go back to what was recorded before."""
    prev = _dispatch._rec.program
    _dispatch._rec.program = program
    _dispatch._rec.stack.append(program)
    _dispatch._RECORDING[0] += 1
    mode = None
    if not any(isinstance(m, _RecordMode) for m in
               torch.overrides._get_current_function_mode_stack()):
        mode = _RecordMode()
        mode.__enter__()
    try:
        with _dispatch.suspend_recording(False):
            yield
    finally:
        if mode is not None:
            mode.__exit__(None, None, None)
        _dispatch._RECORDING[0] -= 1
        _dispatch._rec.stack.pop()
        _dispatch._rec.program = prev


def recording():
    """Whether this thread is recording a Program (outside any op being
    recorded)."""
    return _dispatch.recorder() is not None


def data(name, shape, dtype="float32", lod_level=0, device=None):
    """A feed placeholder of the current program (``paddle.static.data``),
    built as zeros on ``device`` (default: the card): a ``None``/-1 dim
    is built as 1, and the executor feeds any size there."""
    build_shape = [1 if (s is None or s == -1) else int(s) for s in shape]
    dev = resolve_device(device)
    t = Tensor(torch.zeros(build_shape, dtype=convert_dtype(dtype),
                           device=dev))
    t.name = name
    prog = default_main_program()
    slot = prog._record_data(t)
    prog.feed_vars[name] = (slot, tuple(-1 if s is None else s
                                        for s in shape), dtype)
    return t


def global_scope():
    return None


@contextmanager
def name_scope(prefix=None):
    yield


def _feed_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        t = unwrap(x).detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return t.to(device=device, dtype=convert_dtype(dtype))


def _host(t, return_numpy):
    if return_numpy:
        return host_array(t)
    return wrap(t)


class Executor:
    """``Executor.run(program, feed, fetch_list)`` (``executor.py:475``).
    ``place`` picks the device the feeds go to: the card unless it names
    the CPU (``"cpu"``, ``CPUPlace()``)."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        from ..observability import tracing as _obs
        if not _obs.enabled("executor"):
            return self._run(program, feed, fetch_list, return_numpy)
        _obs.count("executor_runs")
        with _obs.trace_span("executor/run", cat="executor"):
            return self._run(program, feed, fetch_list, return_numpy)

    def _run(self, program, feed, fetch_list, return_numpy):
        prog = program or default_main_program()
        from .transpiler import PsServerProgram
        if isinstance(prog, PsServerProgram):  # listen_and_serv
            prog.run_server()
            return []
        if prog._ps_ctx is not None:  # a transpiled trainer program
            return prog._ps_ctx.run_step(self, prog, feed, fetch_list,
                                         return_numpy)
        if not prog.ops:  # a startup program: parameters are initialised
            return []
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        feed_names = sorted(n for n in feed if n not in prog._pruned_feeds)
        feed_slots = [prog.feed_vars[n][0] for n in feed_names]
        feed_vals = [_feed_tensor(feed[n], prog.feed_vars[n][2], self.device)
                     for n in feed_names]
        if any(isinstance(v, _GradVar) for v in fetch_list):
            if prog._optimizer is not None:
                from ..core.enforce import UnimplementedError
                raise UnimplementedError(
                    "fetching @GRAD vars from a program with an attached "
                    "optimizer is not supported: the grad-fetch path would "
                    "skip the fused train step. Run the training program "
                    "without @GRAD fetches, or compute grads from a program "
                    "that has no optimizer (append_backward/gradients + "
                    "exe.run)")
            outs = self._run_with_grads(prog, feed_names, feed_slots,
                                        feed_vals, fetch_list)
            return [_host(v, return_numpy) for v in outs]
        fetch_slots = [prog._slot_of(v, create=False) for v in fetch_list]
        if None in fetch_slots:
            raise ValueError("a fetched variable is not recorded in this "
                             "program")
        opt = prog._optimizer
        key = ("train" if opt is not None else "infer", tuple(feed_names),
               tuple(tuple(v.shape) for v in feed_vals),
               tuple(v.dtype for v in feed_vals), tuple(fetch_slots))
        step = prog._compiled.get(key)
        if step is None:
            step = prog._compiled[key] = self._build_step(
                prog, feed_slots, fetch_slots)
        # a program without feeds runs eagerly: its device is its tensors'
        outs = step(*feed_vals) if feed_vals else step._fn()
        return [_host(v, return_numpy) for v in outs]

    @staticmethod
    def _build_step(prog, feed_slots, fetch_slots):
        """One ``to_static`` program: the replay (inference), or the
        replay, backward and optimizer step (training)."""
        from ..jit.to_static import to_static
        opt, loss_slot = prog._optimizer, prog._loss_slot
        if opt is not None and loss_slot is None:
            raise ValueError("the program's optimizer has no loss to "
                             "minimize")
        prog_ref = weakref.ref(prog)  # the program holds this step

        def step(*feeds):
            prog = prog_ref()
            env = prog._env()
            env.update(zip(feed_slots, feeds))
            if opt is None:
                with torch.no_grad():
                    prog._replay(env)
                return tuple(env[s] for s in fetch_slots)
            prog._replay(env)
            loss = env[loss_slot]
            (loss if loss.dim() == 0 else loss.sum()).backward()
            opt.step()
            opt.clear_grad()
            return tuple(env[s].detach() for s in fetch_slots)

        step.__name__ = "executor_train" if opt else "executor_infer"
        return to_static(step)

    def _run_with_grads(self, prog, feed_names, feed_slots, feed_vals,
                        fetch_list):
        """The ``X@GRAD`` fetches: ``torch.autograd.grad`` of the summed
        targets (each seeded by its ``target_gradients`` entry) with
        respect to the sources, which may be feeds, parameters or
        intermediates."""
        from ..core.enforce import InvalidArgumentError, enforce
        from ..jit.to_static import to_static
        grads = [(i, v) for i, v in enumerate(fetch_list)
                 if isinstance(v, _GradVar)]
        normal = [(i, v) for i, v in enumerate(fetch_list)
                  if not isinstance(v, _GradVar)]
        sigs = {(tuple(prog._slot_of(t, create=False) for t in g.targets),
                 frozenset(prog._slot_of(v, create=False) for v in g.no_grad),
                 None if g.target_gradients is None
                 else tuple(id(t) for t in g.target_gradients))
                for _, g in grads}
        enforce(len(sigs) == 1,
                "all fetched @GRAD vars in one run must share the same "
                "targets/no_grad_set/target_gradients recorded in this "
                f"program; got {sorted(sigs, key=str)}", InvalidArgumentError)
        tslots, ng, _ = next(iter(sigs))
        enforce(None not in tslots,
                "gradients() target was not recorded in this program",
                InvalidArgumentError)
        g0 = grads[0][1]
        seeds = g0.target_gradients
        pattern = None if seeds is None else tuple(t is not None
                                                   for t in seeds)
        seed_vals = [] if seeds is None else [
            (unwrap(t).detach() if isinstance(t, torch.Tensor)
             else torch.from_numpy(np.asarray(t))).to(self.device)
            for t in seeds if t is not None]
        ng_slots = set(ng) - {None}
        src_all = [prog._slot_of(g.source, create=False) for _, g in grads]
        for (_, g), s in zip(grads, src_all):
            enforce(s is not None,
                    f"gradients() source {g.source!r} was never used by "
                    "any op recorded in this program", InvalidArgumentError)
        srcs = list(dict.fromkeys(src_all))
        enforce(not (set(srcs) & ng_slots),
                "a gradients() source cannot also be in no_grad_set",
                InvalidArgumentError)
        fetch_slots = [prog._slot_of(v, create=False) for _, v in normal]
        feed_set = set(feed_slots)
        inter = [s for s in srcs if s not in feed_set and s not in prog.params]
        n_feeds = len(feed_vals)

        prog_ref = weakref.ref(prog)  # the program holds this step

        def grad_step(*vals):
            prog = prog_ref()
            feeds, tg = vals[:n_feeds], vals[n_feeds:]
            env = prog._env()
            env.update(zip(feed_slots, feeds))
            leaves = {}
            for s in srcs:
                if s in env:
                    leaves[s] = env[s] = env[s].detach().requires_grad_()
            post = {}
            for s in inter:
                def take(o, s=s):
                    leaves[s] = o.detach().requires_grad_()
                    return leaves[s]
                post[s] = take
            for s in ng_slots:
                if s in env:
                    env[s] = env[s].detach()
                elif s not in post:
                    post[s] = torch.Tensor.detach
            with torch.enable_grad():
                prog._replay(env, post_write=post or None)
                it = iter(tg)
                total = 0
                for j, ts in enumerate(tslots):
                    t = env[ts]
                    if pattern is not None and pattern[j]:
                        total = total + (t.float() * next(it).float()).sum()
                    else:
                        total = total + t.sum().float()
                inputs = [leaves[s] for s in srcs]
                gs = (torch.autograd.grad(total, inputs, allow_unused=True)
                      if total.requires_grad else [None] * len(inputs))
            gs = [torch.zeros_like(x) if g is None else g
                  for g, x in zip(gs, inputs)]
            return (tuple(env[s].detach() for s in fetch_slots), tuple(gs))

        key = ("grads", tuple(feed_names),
               tuple(tuple(v.shape) for v in feed_vals), tuple(fetch_slots),
               tuple(srcs), tslots, tuple(sorted(ng_slots)), pattern)
        step = prog._compiled.get(key)
        if step is None:
            grad_step.__name__ = "executor_grads"
            step = prog._compiled[key] = to_static(grad_step)
        normals, gs = step(*feed_vals, *seed_vals)
        by_slot = dict(zip(srcs, gs))
        out = [None] * len(fetch_list)
        for (i, _), v in zip(normal, normals):
            out[i] = v
        for (i, _), s in zip(grads, src_all):
            out[i] = by_slot[s]
        return out

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Run the program over a fleet dataset's batches
        (``executor.py:1802``); returns the last run's fetches."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        prog = program or default_main_program()
        last = None
        for i, feed in enumerate(dataset.batches()):
            out = self.run(prog, feed=feed, fetch_list=fetch_list or [])
            if fetch_list:
                last = out
                if debug and i % print_period == 0:
                    names = fetch_info or [f"fetch_{j}"
                                           for j in range(len(out))]
                    print(" ".join(f"{n}={np.asarray(v).mean():.6f}"
                                   for n, v in zip(names, out)))
        return last

    def infer_from_dataset(self, program=None, dataset=None, **kwargs):
        """The same loop over the program's evaluation clone."""
        prog = (program or default_main_program()).clone(for_test=True)
        return self.train_from_dataset(program=prog, dataset=dataset,
                                       **kwargs)

    def close(self):
        pass


class Operator:
    """A view of one recorded op (``framework.py`` Operator:1921)."""

    def __init__(self, prog, rec, idx):
        self._prog = prog
        self._rec = rec
        self.idx = idx

    @property
    def type(self):
        return self._rec.name or "unknown"

    def input_arg_names(self):
        return [f"slot_{s}" for s in self._rec.in_slots()]

    def output_arg_names(self):
        return [f"slot_{s}" for s in self._rec.out_slots]

    def __repr__(self):
        return (f"Operator(type={self.type}, in={self.input_arg_names()}, "
                f"out={self.output_arg_names()})")


class Block:
    """A view of the program's block (``framework.py`` Block:2522)."""

    def __init__(self, prog):
        self.program = prog
        self.idx = 0

    @property
    def ops(self):
        return [Operator(self.program, rec, i)
                for i, rec in enumerate(self.program.ops)]

    def var(self, name):
        feed = self.program.feed_vars.get(name)
        if feed is not None:
            for t in self.program._keepalive:
                if self.program._tensor_slot.get(id(t)) == feed[0]:
                    return t
        for t in self.program.params.values():
            if getattr(t, "name", None) == name or getattr(
                    t, "param_name", None) == name:
                return t
        raise ValueError(f"block has no var {name!r}")

    def all_parameters(self):
        return [t for t in self.program.params.values()
                if isinstance(t, torch.nn.Parameter)]


class _GradVar:
    """The fetchable ``X@GRAD`` of ``append_backward``/``gradients``
    (``backward.py:1377``, ``:1972``): d(sum of ``targets``)/d(``source``),
    each target seeded by its ``target_gradients`` entry, ``no_grad``
    variables held constant."""

    def __init__(self, source, target, target_gradients=None, no_grad=()):
        self.source = source
        self.targets = target if isinstance(target, tuple) else (target,)
        self.target_gradients = target_gradients
        self.no_grad = tuple(no_grad)
        self.name = f"{_name_of(source)}@GRAD"

    @property
    def target(self):
        return self.targets[0]

    def __repr__(self):
        return f"_GradVar({self.name})"


def _name_of(t):
    return (getattr(t, "param_name", None) or getattr(t, "name", None)
            or f"tensor_{id(t)}")


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Mark ``loss`` for the executor's training step and return
    ``[(param, param@GRAD)]`` (``backward.py`` append_backward:1377)."""
    prog = default_main_program()
    prog._loss_slot = prog._slot_of(loss, create=False)
    params = parameter_list if parameter_list is not None else [
        t for t in prog.params.values()
        if isinstance(t, torch.nn.Parameter) and t.requires_grad]
    skip = {id(t) for t in (no_grad_set or ())}
    return [(p, _GradVar(p, loss)) for p in params if id(p) not in skip]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(targets)/d(inputs) as fetchable variables (``backward.py``
    gradients:1972): several targets sum, ``target_gradients`` seed each
    target (None entries: ones), inputs may be feeds, parameters or
    intermediates, ``no_grad_set`` variables are constants."""
    tgts = tuple(targets) if isinstance(targets, (list, tuple)) else (targets,)
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None:
        tg = (tuple(target_gradients)
              if isinstance(target_gradients, (list, tuple))
              else (target_gradients,))
        if len(tg) != len(tgts):
            raise ValueError(
                f"target_gradients length {len(tg)} != targets {len(tgts)}")
    else:
        tg = None
    ng = tuple(no_grad_set) if no_grad_set else ()
    return [_GradVar(v, tgts, target_gradients=tg, no_grad=ng) for v in ins]
