"""Control flow: ``cond``, ``case``, ``switch_case``, ``while_loop`` and
the TensorArray ops (counterpart: ``paddle_tpu/nn/control_flow.py``; the
reference's ``control_flow.py`` while_loop:1075, cond:2298, case:2712,
switch_case:3007).

Three regimes, picked by where the predicate is:

- **Eager** (a host value, or a tensor outside any capture): plain
  Python; autograd differentiates the branch that ran. A CUDA predicate
  is read on the host. Inside a step program's eager warm-up
  (``jit.in_tracing()``) every untaken branch also runs once, without
  gradients, its results dropped, so that the capture after it finds
  every kernel of every branch warmed up.
- **Recorded** (under ``static.program_guard``): each branch, and a
  loop's condition and body, is recorded once into an op list of its own
  (a sub-block; the tensors it reads from outside are its inputs), and
  the construct is one op of the Program (``conditional_block``,
  ``switch``, ``while``). Its replay takes the regime of its predicate.
- **Captured** (a CUDA predicate while ``torch.cuda.graph`` captures):
  CUDA-graph conditional nodes. ``cond``/``case``/``switch_case`` are a
  chain of IF nodes (``kernels/graph_while.py``, a hand-written CUDA
  extension: the card's torch exposes no conditional nodes), one per
  branch, over the branch's position; each writes the merged outputs.
  Autograd cannot see that a branch was conditional, so where gradients
  flow the construct is an ``autograd.Function`` whose backward is the
  same chain of IF nodes, each running its branch's vector-Jacobian
  product on the saved predicate: the gradient is the taken branch's,
  whatever the untaken one's derivative. An unbounded ``while_loop``
  without gradients is a WHILE node of the same extension; with
  ``maximum_trip_count`` it is the reference's masked loop of that many
  trips, differentiable, its float outputs NaN where the bound cut the
  loop short. An unbounded loop that needs gradients raises.

Branch bodies must be free of side effects, as in the reference.
"""
import torch

from ..core import dispatch as _dispatch
from ..core.tensor import Tensor, unwrap, wrap
from ..static.program import _flat_tensors as _flat

__all__ = ["while_loop", "cond", "case", "switch_case", "create_array",
           "array_write", "array_read", "array_length"]


def _capturing(t):
    return (isinstance(t, torch.Tensor) and t.is_cuda
            and torch.cuda.is_current_stream_capturing())


def _warming_up(t):
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        return False
    from ..jit.to_static import in_tracing
    return in_tracing()


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def _structure(tree):
    if isinstance(tree, torch.Tensor):
        return ("t", tuple(tree.shape), tree.dtype)
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return ("c", tree)


def _if_body(pred):
    """The block captured into an IF node of the graph being captured,
    run where the 0-d bool ``pred`` holds at replay."""
    from ..kernels.graph_while import if_body
    return if_body(pred)


# -- sub-blocks ---------------------------------------------------------------

class _Block:
    """One branch (or a loop's condition or body) as a recorded op list:
    ``inputs`` are the slots of its arguments (a loop's variables),
    ``outputs`` the slots of its results, ``ext`` the tensors it reads
    from outside (by slot)."""

    def __init__(self, fn, args, live, device):
        from ..static.program import Program, recording_into
        self.prog = Program()
        self.prog._record_all = True
        self.prog._live = live
        flat = _flat(list(args), [])
        self.inputs = [self.prog._record_data(a) for a in flat]
        with recording_into(self.prog):
            out = _numbers_as_tensors(fn(*args), device)
        self.template = out
        outs = _flat(out, [])
        self.outputs = [self.prog._slot_of(o) for o in outs]
        self.out_values = outs
        self.ext = dict(self.prog.params)  # slot -> outside tensor

    def run(self, ext_of, args=()):
        """Replay with each outside tensor ``t`` read as ``ext_of[id(t)]``
        and the arguments ``args``; returns the flat outputs."""
        env = {s: ext_of.get(id(t), t) for s, t in self.ext.items()}
        env.update(zip(self.inputs, args))
        self.prog._replay(env)
        return [env[s] for s in self.outputs]


def _numbers_as_tensors(tree, device):
    """A branch's host numbers (a lowered ``break`` flag, a counter) as
    0-d tensors: both branches of a construct return tensors alike."""
    if isinstance(tree, bool):
        return torch.full((), tree, dtype=torch.bool, device=device)
    if isinstance(tree, int):
        return torch.full((), tree, dtype=torch.int64, device=device)
    if isinstance(tree, float):
        return torch.full((), tree, dtype=torch.float32, device=device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numbers_as_tensors(v, device) for v in tree)
    return tree


def _union_ext(blocks):
    seen, ext = set(), []
    for b in blocks:
        for t in b.ext.values():
            if id(t) not in seen:
                seen.add(id(t))
                ext.append(t)
    return ext


def _check_same(structures, what):
    if any(s != structures[0] for s in structures[1:]):
        raise ValueError(f"{what} branches returned different structures "
                         f"or shapes: {structures}")


# -- the branch runtime ---------------------------------------------------------

class _BranchState:
    def __init__(self, blocks, ext, preds, res):
        self.blocks = blocks
        self.ext = ext
        self.preds = preds
        self.res = res


class _Link(torch.autograd.Function):
    """Connects a captured IF chain's merged outputs to the tensors its
    branches read; the backward is an IF chain of the branches'
    vector-Jacobian products on the saved predicates."""

    @staticmethod
    def forward(ctx, state, *ext):
        ctx.state = state
        return tuple(r.view_as(r) for r in state.res)

    @staticmethod
    def backward(ctx, *grads):
        st = ctx.state
        diff = [i for i, e in enumerate(st.ext)
                if e.requires_grad and e.is_floating_point()]
        bufs = {i: torch.zeros_like(st.ext[i]) for i in diff}
        for block, pred in zip(st.blocks, st.preds):
            with _if_body(pred):
                with torch.enable_grad():
                    leaves = {id(st.ext[i]): st.ext[i].detach()
                              .requires_grad_() for i in diff}
                    outs = block.run(leaves)
                    pairs = [(o, g) for o, g in zip(outs, grads)
                             if o.requires_grad and g is not None]
                    inputs = [leaves[id(st.ext[i])] for i in diff]
                    gs = (torch.autograd.grad(
                        [o for o, _ in pairs], inputs,
                        [g for _, g in pairs], allow_unused=True)
                        if pairs else [None] * len(inputs))
                for i, g in zip(diff, gs):
                    if g is None:
                        bufs[i].zero_()
                    else:
                        bufs[i].copy_(g)
        return (None,) + tuple(bufs.get(i) for i in range(len(st.ext)))


def _needs_grad(tensors):
    return torch.is_grad_enabled() and any(
        t.requires_grad and t.is_floating_point() for t in tensors)


def _captured_branches(preds, fns=None, blocks=None, ext_vals=None):
    """The IF chain: branch i runs where ``preds[i]``. Either ``fns``
    (called now, each recorded live into its IF body) or ``blocks``
    (recorded before; their outside tensors read from ``ext_vals``)."""
    n = len(preds)
    res = None
    template = None
    recorded = []
    ext_of = {}
    if blocks is not None:
        ext_of = {id(t): v for t, v in zip(_union_ext(blocks), ext_vals)}
    with torch.no_grad():
        for i in range(n):
            with _if_body(preds[i]):
                if blocks is None:
                    block = _Block(fns[i], (), live=True, device=preds[i].device)
                    outs = block.out_values
                    recorded.append(block)
                    tmpl = block.template
                else:
                    outs = blocks[i].run(ext_of)
                    tmpl = blocks[i].template
                if res is None:
                    res = [torch.empty_like(o) for o in outs]
                    template = tmpl
                elif [tuple(o.shape) for o in outs] != [
                        tuple(r.shape) for r in res]:
                    raise ValueError("the branches returned outputs of "
                                     "different shapes")
                for r, o in zip(res, outs):
                    r.copy_(o)
    blocks = blocks if blocks is not None else recorded
    if blocks is recorded:
        ext = _union_ext(blocks)
    else:
        ext = list(ext_vals)
        # the recorded blocks read their outside tensors under their build
        # identities: map those to this replay's values for the backward
        blocks = [_Rebound(b, ext_of) for b in blocks]
    if _needs_grad(ext):
        res = list(_Link.apply(_BranchState(blocks, ext, preds, res), *ext))
    return template, res


class _Rebound:
    """A recorded block whose outside tensors are read through a mapping
    from their build identities to this replay's tensors."""

    def __init__(self, block, ext_of):
        self.block = block
        self.ext_of = ext_of

    def run(self, ext_of, args=()):
        mapped = {k: ext_of.get(id(v), v) for k, v in self.ext_of.items()}
        return self.block.run(mapped, args)


def _position_preds(pos, n):
    return [pos == i for i in range(n)]


def _run_recorded(pos, blocks, ext_vals):
    """A recorded construct at replay (or at its build, on placeholders):
    ``pos`` selects the block."""
    if _capturing(pos):
        template, res = _captured_branches(
            _position_preds(pos.reshape(()), len(blocks)), blocks=blocks,
            ext_vals=ext_vals)
        return tuple(res)
    ext_of = {id(t): v for t, v in zip(_union_ext(blocks), ext_vals)}
    i = int(pos)
    if _warming_up(pos):
        with torch.no_grad():
            for j, b in enumerate(blocks):
                if j != i:
                    b.run(ext_of)
    return tuple(blocks[i].run(ext_of))


def _record_branches(prog, pos, fns, name):
    """Record ``fns`` as sub-blocks and the construct as one op of
    ``prog`` over ``pos``; returns its outputs in the branches' nest."""
    blocks = [_Block(fn, (), live=False, device=pos.device) for fn in fns]
    _check_same([_structure(b.template) for b in blocks], name)
    ext = _union_ext(blocks)

    def construct(pos, *ext_vals):
        return _run_recorded(pos, blocks, ext_vals)
    construct.__name__ = name
    out = prog._record(construct, (pos, *ext), {}, name, plain_body=True)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return _rebuild(blocks[0].template, iter(outs))


def _branches(pos, fns, name, pick):
    """Dispatch a construct over ``fns`` by position ``pos`` (a tensor or
    a host int); ``pick()`` gives the eager position."""
    prog = _dispatch.recorder()
    if prog is not None and isinstance(pos, torch.Tensor):
        # recorded even on a constant predicate: a placeholder's value
        # must not pick the branch
        return _record_branches(prog, unwrap(pos), fns, name)
    p = unwrap(pos)
    if _capturing(p):
        preds = _position_preds(p.reshape(()), len(fns))
        template, res = _captured_branches(preds, fns=fns)
        out = _rebuild(template, iter(res))
        return wrap(out) if isinstance(pos, Tensor) else out
    i = pick()
    if _warming_up(p):
        with torch.no_grad():
            for j, fn in enumerate(fns):
                if j != i:
                    fn()
    return fns[i]()


def cond(pred, true_fn=None, false_fn=None, name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``."""
    p = unwrap(pred)
    if not isinstance(p, torch.Tensor):
        taken = true_fn if bool(p) else false_fn
        return taken() if taken is not None else None
    if true_fn is None or false_fn is None:
        if _capturing(p) or _dispatch.recorder() is not None:
            raise ValueError("cond with a tensor predicate under capture or "
                             "recording requires both true_fn and false_fn")
        taken = true_fn if bool(p.reshape(())) else false_fn
        return taken() if taken is not None else None
    pos = (~p.reshape(()).bool()).long()  # 0: true_fn, 1: false_fn
    if isinstance(pred, Tensor):
        pos = wrap(pos)
    return _branches(pos, [true_fn, false_fn], "conditional_block",
                     lambda: 0 if bool(p.reshape(())) else 1)


def _table(branch_fns):
    if isinstance(branch_fns, dict):
        return dict(branch_fns)
    fns = list(branch_fns)
    if fns and isinstance(fns[0], (list, tuple)):
        return {int(k): fn for k, fn in fns}
    return dict(enumerate(fns))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch whose key equals ``branch_index``, else ``default``
    (``None``: the branch of the highest key). ``branch_fns``: a dict
    ``{int: fn}``, a list of ``(int, fn)`` or a list of fns."""
    table = _table(branch_fns)
    keys = sorted(table)
    if default is None:
        default = table[keys[-1]]
    idx = unwrap(branch_index)
    if not isinstance(idx, torch.Tensor):
        return table.get(int(idx), default)()
    fns = [table[k] for k in keys] + [default]
    flat = idx.reshape(()).long()
    pos = torch.full_like(flat, len(keys))
    for i, k in enumerate(keys):
        pos = torch.where(flat == k, torch.full_like(flat, i), pos)
    if isinstance(branch_index, Tensor):
        pos = wrap(pos)

    def pick():
        k = int(flat)
        return keys.index(k) if k in table else len(keys)
    return _branches(pos, fns, "switch", pick)


def case(pred_fn_pairs, default=None, name=None):
    """The fn of the first true predicate, else ``default`` (``None``:
    the last pair's fn)."""
    pairs = list(pred_fn_pairs)
    if default is None:
        default = pairs[-1][1]
    preds = [unwrap(p) for p, _ in pairs]
    if not any(isinstance(p, torch.Tensor) for p in preds):
        for p, (_, fn) in zip(preds, pairs):
            if bool(p):
                return fn()
        return default()
    dev = next(p.device for p in preds if isinstance(p, torch.Tensor))
    stacked = torch.stack([
        p.reshape(()).bool() if isinstance(p, torch.Tensor)
        else torch.full((), bool(p), device=dev) for p in preds])
    first = torch.argmax(stacked.to(torch.int32)).long()
    pos = torch.where(stacked.any(), first,
                      torch.full_like(first, len(pairs)))
    if any(isinstance(p, Tensor) for p, _ in pairs):
        pos = wrap(pos)
    fns = [fn for _, fn in pairs] + [default]

    def pick():
        for i, p in enumerate(preds):
            if bool(p.reshape(()) if isinstance(p, torch.Tensor) else p):
                return i
        return len(pairs)
    return _branches(pos, fns, "case", pick)


# -- while_loop -----------------------------------------------------------------

def _as_bool(c):
    c = unwrap(c)
    return c.reshape(()).bool() if isinstance(c, torch.Tensor) else bool(c)


def _state_tensors(vars_, device):
    """The loop variables as tensors (a host scalar becomes a 0-d tensor,
    made by a fill kernel: no host copy under a capture)."""
    out = []
    for v in vars_:
        v = unwrap(v)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (bool, int, float)):
            dt = (torch.bool if isinstance(v, bool) else torch.int64
                  if isinstance(v, int) else torch.float32)
            out.append(torch.full((), v, dtype=dt, device=device))
        else:
            raise TypeError(f"a loop variable must be a tensor or a number, "
                            f"got {type(v).__name__}")
    return out


def _step(body, vars_):
    out = body(*vars_)
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _poison(vals, truncated):
    return [torch.where(truncated, torch.full_like(v, float("nan")), v)
            if v.is_floating_point() else v for v in vals]


def _bounded(cond_fn, body, vars_, n):
    """The reference's masked loop of ``n`` trips: each trip runs the
    body and keeps its result only while the loop is live; float outputs
    are NaN if the condition still held after ``n`` trips."""
    done = torch.zeros((), dtype=torch.bool, device=vars_[0].device)
    for _ in range(int(n)):
        c = _as_bool(cond_fn(*vars_))
        new = _step(body, vars_)
        active = torch.logical_and(torch.logical_not(done), c)
        vars_ = [torch.where(active, nv, v) for nv, v in zip(new, vars_)]
        done = torch.logical_or(done, torch.logical_not(c))
    return _poison(vars_, _as_bool(cond_fn(*vars_)))


def _host_loop(cond_fn, body, vars_, bound=None):
    """A Python loop; with ``bound``, at most that many trips, the float
    outputs NaN if the condition still holds after them."""
    trips = 0
    vars_ = [v.clone() for v in vars_]  # a body may write them in place
    while bool(_as_bool(cond_fn(*vars_))):
        if bound is not None and trips == int(bound):
            return _poison(vars_, torch.ones((), dtype=torch.bool,
                                             device=vars_[0].device))
        vars_ = _step(body, vars_)
        trips += 1
    return vars_


def _assign(carry, new):
    """Write an iteration's results into the loop's buffers in place, each
    as of the iteration's start: a result that is, or shares storage with,
    one of ``carry`` (a variable handed back in another position, as in
    ``a, b = a + b, a``) is copied out before any buffer is written."""
    held = {c.untyped_storage().data_ptr() for c in carry}
    staged = [n if n is c else n.clone()
              if n.untyped_storage().data_ptr() in held else n
              for c, n in zip(carry, new)]
    for c, n in zip(carry, staged):
        if n is not c:  # a variable the body hands back as it is
            c.copy_(n)


def _while_node(cond_fn, body, vars_):
    from ..kernels.graph_while import while_node
    carry = [v.clone() for v in vars_]
    pred = _as_bool(cond_fn(*carry)).clone()

    def iteration():
        new = _step(body, carry)
        if [tuple(n.shape) for n in new] != [tuple(c.shape) for c in carry]:
            raise ValueError("the loop body must keep its variables' shapes")
        _assign(carry, new)
        pred.copy_(_as_bool(cond_fn(*carry)))
    while_node(pred, iteration)
    return carry


def _run_loop(cond_fn, body, vars_, bound, recorded):
    """``vars_`` are tensors; picks the regime."""
    if any(_capturing(v) for v in vars_):
        if bound is not None:
            return _bounded(cond_fn, body, vars_, bound)
        if _needs_grad(vars_):
            raise ValueError(
                "while_loop under capture with gradients needs a static "
                "bound: pass maximum_trip_count=N (an unbounded loop cannot "
                "be reverse-differentiated), or wrap the loop in no_grad()")
        return _while_node(cond_fn, body, vars_)
    return _host_loop(cond_fn, body, vars_, bound if recorded else None)


def while_loop(cond, body, loop_vars, is_test=False, name=None,
               maximum_trip_count=None):
    """``while cond(*vars): vars = body(*vars)``; returns the final
    variables as a list."""
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("loop_vars must be a non-empty list/tuple")
    wrapped = any(isinstance(v, Tensor) for v in loop_vars)
    plain = [unwrap(v) for v in loop_vars]
    tensors = [v for v in plain if isinstance(v, torch.Tensor)]
    prog = _dispatch.recorder()
    if prog is not None and tensors:  # placeholders must not pick the trips
        return _record_while(prog, cond, body, plain, maximum_trip_count,
                             wrapped)
    if not tensors:  # host values only: a Python loop
        vars_ = list(loop_vars)
        while bool(_as_bool(cond(*vars_))):
            vars_ = _step(body, vars_)
        return vars_
    vars_ = _state_tensors(plain, tensors[0].device)
    out = _run_loop(cond, body, vars_, maximum_trip_count, recorded=False)
    return wrap(out) if wrapped else out


def _record_while(prog, cond_fn, body, plain, bound, wrapped):
    if prog._live:
        raise NotImplementedError(
            "a while_loop inside a cond/case/switch_case branch under a "
            "CUDA-graph capture is not supported; move the loop out of the "
            "branch")
    dev = next(v.device for v in plain if isinstance(v, torch.Tensor))
    vars_ = _state_tensors(plain, dev)
    # the blocks record over copies: a body that writes its variables in
    # place must not write the program's at build
    with _dispatch.suspend_recording():
        c_args = [v.detach().clone() for v in vars_]
        b_args = [v.detach().clone() for v in vars_]
    c_block = _Block(lambda *vs: cond_fn(*vs), c_args, live=False,
                     device=dev)
    b_block = _Block(lambda *vs: tuple(_step(body, list(vs))), b_args,
                     live=False, device=dev)
    if [_structure(v) for v in _flat(b_block.template, [])] != [
            _structure(v) for v in vars_]:
        raise ValueError("while_loop's body must return its variables' "
                         "structure, shapes and dtypes")
    ext = _union_ext([c_block, b_block])
    n_vars = len(vars_)

    def loop(*vals):
        vs, ext_vals = list(vals[:n_vars]), vals[n_vars:]
        ext_of = {id(t): v for t, v in zip(ext, ext_vals)}

        def c(*a):
            return c_block.run(ext_of, a)[0]

        def b(*a):
            return b_block.run(ext_of, a)
        return tuple(_run_loop(c, b, vs, bound, recorded=True))
    loop.__name__ = "while"
    out = prog._record(_build_time_once(loop, b_block), (*vars_, *ext), {},
                       "while", plain_body=True)
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    return wrap(out) if wrapped else out


def _build_time_once(loop, b_block):
    """The recorded loop: at build (on the Program's placeholder values,
    whose trip count means nothing) the body's outputs stand for the
    loop's, from one recorded trip; at replay the loop runs."""
    state = {"built": False}

    def run(*vals):
        if not state["built"]:
            state["built"] = True
            return tuple(v.clone() for v in b_block.out_values)
        return loop(*vals)
    run.__name__ = "while"
    return run


# -- TensorArray: eager list semantics -------------------------------------------

def create_array(dtype="float32"):
    """A LoDTensorArray as a Python list; inside captured or recorded
    control flow carry a preallocated tensor with index writes instead."""
    return []


def _check_array(array, opname):
    if not isinstance(array, list):
        raise TypeError(f"{opname} expects a list created by create_array")


def _index(i):
    i = unwrap(i)
    return int(i.reshape(())) if isinstance(i, torch.Tensor) else int(i)


def array_write(x, i, array=None):
    if array is None:
        array = create_array()
    _check_array(array, "array_write")
    idx = _index(i)
    if idx == len(array):
        array.append(x)
    elif idx < len(array):
        array[idx] = x
    else:
        raise IndexError(
            f"array_write index {idx} beyond array length {len(array)}")
    return array


def array_read(array, i):
    _check_array(array, "array_read")
    return array[_index(i)]


def array_length(array):
    _check_array(array, "array_length")
    return Tensor(torch.tensor(len(array), dtype=torch.int64))
