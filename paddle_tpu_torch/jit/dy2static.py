"""AST transformation of data-dependent Python control flow for
``to_static`` (counterpart: ``paddle_tpu/jit/dy2static.py``; the
reference's ``dygraph_to_static`` ``ifelse_transformer.py``,
``loop_transformer.py``, ``convert_call_func.py``).

On the CPU a step program is a plain loop over eager calls, so ``if
tensor:`` just works there. On the card a program is a captured CUDA
graph, and a branch or loop on a tensor's value is a host read that the
capture refuses. ``StaticFunction`` finds such reads in its eager warm-up
unit (a ``__bool__``, ``item``, ``int`` or ``float`` of a device tensor)
and then captures the transformed function instead, whose rewritten
control flow reaches ``nn.control_flow``'s conditional nodes:

    if t: A else: B       ->  tuple-assigned convert_if(t, true_fn, false_fn)
    while t: B            ->  convert_while(test_fn, body_fn, loop_vars)
    for i in range(t): B  ->  the while form with an injected counter
    a and b / or / not    ->  convert_bool_op / convert_not
    f(x)                  ->  convert_call(f)(x)   (recurses into user code)

A value is "traced" here when it is a tensor on the card while a graph is
captured, or a variable of a Program being recorded
(``static.program_guard``); otherwise the helpers run plain Python, so
the transformed function means what the original means. The rewrites
(``return`` inside ``if`` and loops, ``break``/``continue`` as carried
flags, ``for x in tensor``) are the reference's, copied; ``while ...
else`` and ``return`` inside a nested loop are left as Python, loudly
rejected once a traced value reaches them.
"""
import ast
import functools
import inspect
import textwrap
import types

import torch

__all__ = ["convert_to_static", "jst"]

_SKIP_MODULE_PREFIXES = (
    "paddle_tpu", "jax", "numpy", "builtins", "torch", "flax", "optax",
    "_pytest", "unittest",
)


def _plain(v):
    from ..core.tensor import unwrap
    return unwrap(v)


def _is_traced(v):
    """A tensor on the card under a capture, or a recorded Program's
    variable."""
    v = _plain(v)
    if not isinstance(v, torch.Tensor):
        return False
    if v.is_cuda and torch.cuda.is_current_stream_capturing():
        return True
    from ..core import dispatch
    prog = dispatch.recorder()
    return prog is not None and prog._is_var(v)


class _Undef:
    """Placeholder for a name unbound before a transformed branch assigns
    it (reference: dygraph_to_static UndefinedVar). Any attribute access,
    arithmetic, indexing or call on it raises an actionable NameError."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"

    @staticmethod
    def _raise(*_a, **_k):
        raise NameError(
            "value is undefined here: it was only assigned in one branch "
            "of a transformed if, or is a per-iteration temporary not "
            "carried by a traced loop; bind it before the branch/loop")

    __bool__ = _raise

    def __getattr__(self, name):
        self._raise()

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _raise
    __truediv__ = __rtruediv__ = __getitem__ = __call__ = __iter__ = _raise
    __len__ = __neg__ = __lt__ = __le__ = __gt__ = __ge__ = _raise


UNDEF = _Undef()


def _to_bool(v):
    v = _plain(v)
    if isinstance(v, torch.Tensor):
        return bool(v.reshape(()))
    return bool(v)


def _as_bool_tensor(v):
    v = _plain(v)
    return v.reshape(()).bool()


class _Jst:
    """Runtime namespace injected into transformed functions as ``_jst``."""

    UNDEF = UNDEF

    @staticmethod
    def local(mapping, name):
        return mapping.get(name, UNDEF)

    @staticmethod
    def convert_if(pred, true_fn, false_fn, args):
        if not _is_traced(pred):
            return true_fn(*args) if _to_bool(pred) else false_fn(*args)
        from ..nn.control_flow import cond
        return cond(pred, lambda: true_fn(*args), lambda: false_fn(*args))

    @staticmethod
    def convert_while(test_fn, body_fn, args):
        # tracedness is re-probed every iteration: a host test (`while
        # True:` with a lowered break flag) turns traced once the body
        # makes the flag a device bool
        vals = tuple(args)
        t = test_fn(*vals)
        while not _is_traced(t):
            if not _to_bool(t):
                return vals
            vals = tuple(body_fn(*vals))
            t = test_fn(*vals)
        return _Jst._traced_while(test_fn, body_fn, vals)

    @staticmethod
    def _traced_while(test_fn, body_fn, args):
        from ..nn.control_flow import while_loop
        # names unbound at loop entry are per-iteration temporaries: not
        # carried, made again inside each iteration
        live = [i for i, v in enumerate(args) if v is not UNDEF]

        def reinsert(vals):
            full = [UNDEF] * len(args)
            for i, v in zip(live, vals):
                full[i] = v
            return full

        out = while_loop(
            lambda *vs: test_fn(*reinsert(vs)),
            lambda *vs: tuple(body_fn(*reinsert(vs))[i] for i in live),
            [args[i] for i in live])
        return tuple(reinsert(out))

    @staticmethod
    def convert_bool_op(op, lhs, rhs_thunk):
        """``a and b`` / ``a or b``: short-circuits on a host ``a``;
        elementwise logical and/or of traced operands."""
        if not _is_traced(lhs):
            lv = _to_bool(lhs)
            if op == "and":
                return rhs_thunk() if lv else lhs
            return lhs if lv else rhs_thunk()
        rhs = rhs_thunk()
        lv = _as_bool_tensor(lhs)
        rv = (_as_bool_tensor(rhs) if isinstance(_plain(rhs), torch.Tensor)
              else torch.full((), bool(rhs), device=lv.device))
        fn = torch.logical_and if op == "and" else torch.logical_or
        return fn(lv, rv)

    @staticmethod
    def convert_not(v):
        if not _is_traced(v):
            return not _to_bool(v)
        return torch.logical_not(_as_bool_tensor(v))

    @staticmethod
    def convert_call(f):
        return _convert_callee(f)

    @staticmethod
    def check_defined(v):
        """Loud failure for a value re-derived after a loop's early
        return that reads a per-iteration temporary the loop did not
        carry."""
        def scan(x):
            if x is UNDEF:
                raise NameError(
                    "a value returned from inside a traced loop depends "
                    "on a per-iteration temporary that is not "
                    "loop-carried; bind it before the loop or return "
                    "loop-carried state")
            if isinstance(x, (tuple, list)):
                for e in x:
                    scan(e)
        scan(v)
        return v

    @staticmethod
    def reject_unsupported(kind, v):
        """Constructs left as Python: fine while host-valued, a clear
        error once a traced value reaches them."""
        if _is_traced(v):
            raise NotImplementedError(
                f"{kind} over a traced (data-dependent) condition or "
                f"iterable is not supported by to_static; restructure "
                f"the control flow (e.g. move the else-clause after the "
                f"loop, or lift the return out of the nested loop)")
        return v

    @staticmethod
    def convert_iterable(v):
        """A for-loop's iterable as an indexable: tensors and sequences
        as they are, a generator through a lazy buffer (its side effects
        as the loop reaches them)."""
        if isinstance(v, (torch.Tensor, list, tuple, range, str)) or hasattr(
                v, "__array__"):
            return v
        return _LazySeq(v)

    @staticmethod
    def convert_iter_cont(v, i):
        """The indexed for-loop's continuation test."""
        if isinstance(v, _LazySeq):
            if _is_traced(i):
                raise NotImplementedError(
                    "iterating a python generator cannot be traced; "
                    "materialize it (list(...)) or iterate a tensor")
            return v.has(int(i))
        n = int(v.shape[0]) if hasattr(v, "shape") else len(v)
        return i < n

    @staticmethod
    def convert_index(v, i):
        return v[i]

    @staticmethod
    def convert_range_cont(i, stop, step):
        """The continuation test of a lowered ``for ... in range(...)``,
        by the step's sign; a zero step raises as Python's does."""
        if not (_is_traced(i) or _is_traced(stop) or _is_traced(step)):
            sv = int(_plain(step))
            if sv == 0:
                raise ValueError("range() arg 3 must not be zero")
            return i < stop if sv > 0 else i > stop
        iv, st, sp = (_plain(v) for v in (i, stop, step))
        dev = next(t.device for t in (iv, st, sp)
                   if isinstance(t, torch.Tensor))

        def t(x):
            return x if isinstance(x, torch.Tensor) else torch.full(
                (), x, device=dev)
        iv, st, sp = t(iv), t(st), t(sp)
        return torch.where(sp > 0, iv < st, iv > st)


class _LazySeq:
    """An incrementally buffered view of a one-shot iterator: indexable,
    but items are pulled only as the loop reaches them."""

    def __init__(self, it):
        self._it = iter(it)
        self._buf = []
        self._done = False

    def _fill(self, i):
        while not self._done and len(self._buf) <= i:
            try:
                self._buf.append(next(self._it))
            except StopIteration:
                self._done = True

    def has(self, i):
        self._fill(i)
        return len(self._buf) > i

    def __getitem__(self, i):
        self._fill(i)
        return self._buf[i]


jst = _Jst()


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# callee conversion (reference: convert_call_func.py convert_call)
# ---------------------------------------------------------------------------

# keyed on the code OBJECT (not id(): a collected code object's id can be
# reused, which would hand an unrelated function a stale transform); the
# cache entry also keeps the code object alive, making the key stable
_fn_cache = {}  # code object -> transformed function (or None)


def _convert_callee(f):
    """Return a control-flow-transformed version of a user callable; pass
    framework/stdlib callables through untouched."""
    from ..nn.layer.layers import Layer

    if isinstance(f, Layer):
        if type(f).__module__.split(".")[0] in _SKIP_MODULE_PREFIXES:
            return f  # the package's own layers hold no user control flow
        if not getattr(f, "_jst_forward_converted", False):
            try:
                fwd = f.forward
                if isinstance(fwd, types.MethodType):
                    conv = convert_to_static(fwd.__func__)
                    f.forward = types.MethodType(conv, f)
            except Exception:
                pass
            object.__setattr__(f, "_jst_forward_converted", True)
        return f
    if getattr(f, "_not_to_static", False):
        return f
    if isinstance(f, types.MethodType):
        conv = _convert_function(f.__func__)
        return types.MethodType(conv, f.__self__) if conv is not None else f
    if isinstance(f, types.FunctionType):
        conv = _convert_function(f)
        return conv if conv is not None else f
    return f


def _convert_function(fn):
    mod = getattr(fn, "__module__", "") or ""
    if mod.split(".")[0] in [p.split(".")[0] for p in _SKIP_MODULE_PREFIXES] \
            or any(mod.startswith(p) for p in _SKIP_MODULE_PREFIXES):
        return None
    key = fn.__code__
    if key in _fn_cache:
        return _fn_cache[key]
    try:
        conv = convert_to_static(fn)
    except (OSError, TypeError, SyntaxError, RecursionError):
        conv = None
    _fn_cache[key] = conv
    return conv


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

def _assigned_names(nodes):
    """Local names assigned anywhere in `nodes` (not descending into
    nested function/class definitions)."""
    names = []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            pass  # nested scope

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            pass

        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                if node.id not in names:
                    names.append(node.id)

    for n in nodes:
        V().visit(n)
    return names


def _contains(nodes, kinds):
    """True if any node of `kinds` appears at this loop/branch level (not
    inside a nested function or nested loop for Break/Continue)."""
    hit = []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

        def generic_visit(self, node):
            if isinstance(node, kinds):
                hit.append(node)
            if isinstance(node, (ast.For, ast.While)) and \
                    kinds != (ast.Return,):
                return  # break/continue bind to the nested loop
            super().generic_visit(node)

    for n in nodes:
        V().visit(n)
    return bool(hit)


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _tuple(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx or ast.Load()) for n in names],
                     ctx=ctx or ast.Load())


def _jst_attr(attr):
    return ast.Attribute(value=_name("_jst"), attr=attr, ctx=ast.Load())


def _contains_break_continue(stmts):
    return _contains(stmts, (ast.Break, ast.Continue))


def _guard_break_continue(stmts, brk, cont, used):
    """Rewrite break/continue at THIS loop level into flag assignments;
    statements after a conditional break/continue are wrapped in an
    `if not (brk or cont):` guard (the reference
    break_continue_transformer's flag scheme). Nested loops keep their
    own break/continue untouched."""
    def set_flag(name):
        return ast.Assign(targets=[_name(name, ast.Store())],
                          value=ast.Constant(True))

    out = []
    for i, st in enumerate(stmts):
        if isinstance(st, ast.Break):
            used.add(brk)
            out.append(set_flag(brk))
            return out  # rest is unreachable (python semantics)
        if isinstance(st, ast.Continue):
            used.add(cont)
            out.append(set_flag(cont))
            return out
        if isinstance(st, (ast.If, ast.With, ast.Try)) and \
                _contains_break_continue([st]):
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(st, attr, None)
                if sub:
                    setattr(st, attr,
                            _guard_break_continue(sub, brk, cont, used)
                            or [ast.Pass()])
            for h in getattr(st, "handlers", []) or []:
                h.body = _guard_break_continue(h.body, brk, cont, used) \
                    or [ast.Pass()]
            out.append(st)
            rest = _guard_break_continue(stmts[i + 1:], brk, cont, used)
            if rest:
                # only reference flags that some branch actually sets
                names = [_name(n) for n in (brk, cont) if n in used]
                flags = (names[0] if len(names) == 1
                         else ast.BoolOp(op=ast.Or(), values=names))
                out.append(ast.If(
                    test=ast.UnaryOp(op=ast.Not(), operand=flags),
                    body=rest, orelse=[]))
            return out
        out.append(st)
    return out


def _rewrite_returns(stmts, sites, mk_flag):
    """Rewrite each `return X` at this loop level into
    ``<flag_k> = True; break`` and record ``(flag_k, X)`` in `sites`
    (the reference return_transformer's early-return-flag scheme). The
    VALUE is not carried through the loop — a per-return boolean flag is
    (bools always unify across cond branches) — and X is re-evaluated
    after the loop from the preserved loop-carried state, which equals
    its value at break time because break exits with the current carry.
    Descends into if/with/try but NOT nested loops or function defs.
    Mutates in place."""
    for st in stmts:
        if isinstance(st, (ast.For, ast.While, ast.FunctionDef,
                           ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(st, attr, None)
            if sub:
                _rewrite_returns(sub, sites, mk_flag)
        for h in getattr(st, "handlers", []) or []:
            _rewrite_returns(h.body, sites, mk_flag)
    out = []
    for st in stmts:
        if isinstance(st, ast.Return):
            flag = mk_flag()
            sites.append((flag, st.value if st.value is not None
                          else ast.Constant(None)))
            out.append(ast.Assign(targets=[_name(flag, ast.Store())],
                                  value=ast.Constant(True)))
            out.append(ast.Break())
            break  # rest of the block is unreachable
        out.append(st)
    stmts[:] = out


def _make_fdef(name, args, body):
    """ast.FunctionDef with every required field (incl. py3.12
    type_params) populated."""
    fd = ast.FunctionDef(name=name, args=args, body=body,
                         decorator_list=[], returns=None,
                         type_comment=None)
    if "type_params" in ast.FunctionDef._fields:
        fd.type_params = []
    return fd


class _Transformer(ast.NodeTransformer):
    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    # -- calls ------------------------------------------------------------
    def visit_Call(self, node):
        self.generic_visit(node)
        # _jst.* helpers and super() stay as-is
        if isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "_jst":
            return node
        if isinstance(node.func, ast.Name) and node.func.id in (
                "super", "locals", "globals", "range", "len", "isinstance",
                "print"):
            return node
        node.func = ast.Call(func=_jst_attr("convert_call"),
                             args=[node.func], keywords=[])
        return node

    # -- boolean operators ------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        op = "and" if isinstance(node.op, ast.And) else "or"
        expr = node.values[0]
        for rhs in node.values[1:]:
            thunk = ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=rhs)
            expr = ast.Call(func=_jst_attr("convert_bool_op"),
                            args=[ast.Constant(op), expr, thunk],
                            keywords=[])
        return expr

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_jst_attr("convert_not"),
                            args=[node.operand], keywords=[])
        return node

    # -- statement lists (return-aware) -----------------------------------
    def process_body(self, stmts):
        """Transform a statement list. An `if` containing `return` is
        lowered by moving the statements AFTER it into the non-returning
        branch (continuation), so both branches become expressions of one
        convert_if — the reference's return_transformer flattening."""
        res = []
        for i, st in enumerate(stmts):
            if isinstance(st, ast.If) and \
                    _contains(st.body + st.orelse, (ast.Return,)):
                res.extend(self._lower_return_if(st, stmts[i + 1:]))
                return res
            if isinstance(st, (ast.While, ast.For)) and not st.orelse \
                    and _contains([st], (ast.Return,)):
                lowered = self._lower_return_loop(st)
                if lowered is not None:
                    # last element is `if rf: return rv`; flatten it with
                    # the statements after the loop as the continuation
                    res.extend(lowered[:-1])
                    res.extend(self._lower_return_if(lowered[-1],
                                                     stmts[i + 1:]))
                    return res
            v = self.visit(st)
            res.extend(v if isinstance(v, list) else [v])
        return res

    def _lower_return_loop(self, node):
        """Lower a loop whose body returns: each return site becomes a
        flag + break, the loop lowers normally, and a trailing
        ``if flag_k: return <expr_k>`` chain re-derives the returned
        value from the preserved carry. Returns None (caller falls back
        to plain python) when a return sits inside a NESTED loop — that
        residual is rejected loudly at runtime."""
        sites = []

        def mk_flag():
            return f"_jst_rf_{self._uid()}"

        _rewrite_returns(node.body, sites, mk_flag)
        if _contains(node.body, (ast.Return,)):
            return None  # return inside a nested loop
        prologue = [ast.Assign(targets=[_name(flag, ast.Store())],
                               value=ast.Constant(False))
                    for flag, _ in sites]
        res = self.visit(node)
        out = prologue + (res if isinstance(res, list) else [res])
        chain = None
        for flag, expr in reversed(sites):
            ret = ast.Return(value=ast.Call(
                func=_jst_attr("check_defined"), args=[expr], keywords=[]))
            chain = ast.If(test=_name(flag), body=[ret],
                           orelse=[chain] if chain is not None else [])
        out.append(chain)
        return out

    def _lower_return_if(self, node, suffix):
        def ends_with_return(body):
            return bool(body) and isinstance(body[-1], ast.Return)

        import copy as _copy
        t_body = list(node.body)
        if not ends_with_return(t_body):
            # deep-copy: the same suffix must not be transformed twice in
            # place when it lands in both branch bodies
            t_body = t_body + _copy.deepcopy(suffix)
        f_body = list(node.orelse)
        if not ends_with_return(f_body):
            f_body = f_body + _copy.deepcopy(suffix)
        test = self.visit(node.test)
        t_body = self.process_body(t_body) or [ast.Pass()]
        f_body = self.process_body(f_body) or [ast.Pass()]
        names = _assigned_names(t_body + f_body)
        uid = self._uid()
        t_name, f_name = f"_jst_rett_{uid}", f"_jst_retf_{uid}"
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        t_def = _make_fdef(t_name, args, t_body)
        f_def = _make_fdef(f_name, args, f_body)
        prologue = [self._bind_undef(n) for n in names]
        call = ast.Call(
            func=_jst_attr("convert_if"),
            args=[test, _name(t_name), _name(f_name), _tuple(names)],
            keywords=[])
        return prologue + [t_def, f_def, ast.Return(value=call)]

    def visit_FunctionDef(self, node):
        node.body = self.process_body(node.body)
        return node

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- if ---------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        if _contains(node.body + node.orelse, (ast.Return,)):
            return node  # unreachable via process_body; safety net
        names = _assigned_names(node.body + node.orelse)
        uid = self._uid()
        t_name, f_name = f"_jst_true_{uid}", f"_jst_false_{uid}"
        args = ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=n) for n in names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        ret = ast.Return(value=_tuple(names))
        t_def = _make_fdef(t_name, args, (node.body or [ast.Pass()]) + [ret])
        f_def = _make_fdef(f_name, args,
                           (node.orelse or [ast.Pass()]) + [ret])
        prologue = [self._bind_undef(n) for n in names]
        call = ast.Call(
            func=_jst_attr("convert_if"),
            args=[node.test, _name(t_name), _name(f_name), _tuple(names)],
            keywords=[])
        assign = (ast.Assign(targets=[_tuple(names, ast.Store())],
                             value=call)
                  if names else ast.Expr(value=call))
        return prologue + [t_def, f_def, assign]

    # -- while ------------------------------------------------------------
    def visit_While(self, node, tail_stmts=None):
        if node.orelse or _contains(node.body, (ast.Return,)):
            # while-else / return-in-a-nested-loop stay plain python, but
            # the condition is wrapped so a traced value produces an
            # actionable error instead of a TracerBoolConversionError
            kind = ("while...else" if node.orelse
                    else "return inside a nested loop")
            self.generic_visit(node)
            node.test = ast.Call(func=_jst_attr("reject_unsupported"),
                                 args=[ast.Constant(kind), node.test],
                                 keywords=[])
            return node
        if _contains_break_continue(node.body):
            uid_f = self._uid()
            brk = f"_jst_brk_{uid_f}"
            cont = f"_jst_cont_{uid_f}"
            used = set()
            body = _guard_break_continue(list(node.body), brk, cont, used)
            if _contains_break_continue(body):
                # a construct the rewrite can't reach still holds a raw
                # break/continue: leave the loop as plain python rather
                # than recursing forever
                node.body = node.body + list(tail_stmts or [])
                self.generic_visit(node)
                return node
            prologue = []
            if cont in used:
                # continue resets every iteration; `tail_stmts` (the
                # for-lowering's index increment) must still run
                body = [ast.Assign(targets=[_name(cont, ast.Store())],
                                   value=ast.Constant(False))] + body
            if brk in used:
                prologue.append(ast.Assign(
                    targets=[_name(brk, ast.Store())],
                    value=ast.Constant(False)))
                node.test = ast.BoolOp(
                    op=ast.And(),
                    values=[ast.UnaryOp(op=ast.Not(), operand=_name(brk)),
                            node.test])
            node.body = body + list(tail_stmts or [])
            res = self.visit_While(node)
            return prologue + (res if isinstance(res, list) else [res])
        node.body = node.body + list(tail_stmts or [])
        self.generic_visit(node)
        names = _assigned_names(node.body)
        # names read by the test that are assigned in the body are already
        # included; other test names are loop-invariant closures
        if not names:
            return node
        uid = self._uid()
        test_name, body_name = f"_jst_test_{uid}", f"_jst_body_{uid}"
        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in names],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        test_def = _make_fdef(test_name, args,
                              [ast.Return(value=node.test)])
        body_def = _make_fdef(body_name, args,
                              node.body + [ast.Return(value=_tuple(names))])
        prologue = [self._bind_undef(n) for n in names]
        call = ast.Call(
            func=_jst_attr("convert_while"),
            args=[_name(test_name), _name(body_name), _tuple(names)],
            keywords=[])
        assign = ast.Assign(targets=[_tuple(names, ast.Store())], value=call)
        return prologue + [test_def, body_def, assign]

    # -- for over range(...) ----------------------------------------------
    def visit_For(self, node):
        if (not node.orelse
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and isinstance(node.target, ast.Name)
                and not _contains(node.body, (ast.Return,))):
            uid = self._uid()
            i = node.target.id
            rargs = node.iter.args
            if len(rargs) == 1:
                start, stop, step = ast.Constant(0), rargs[0], ast.Constant(1)
            elif len(rargs) == 2:
                start, stop, step = rargs[0], rargs[1], ast.Constant(1)
            else:
                start, stop, step = rargs
            stop_name = f"_jst_stop_{uid}"
            step_name = f"_jst_step_{uid}"
            it_name = f"_jst_it_{uid}"
            init = [ast.Assign(targets=[_name(it_name, ast.Store())],
                               value=start),
                    ast.Assign(targets=[_name(stop_name, ast.Store())],
                               value=stop),
                    ast.Assign(targets=[_name(step_name, ast.Store())],
                               value=step)]
            test = ast.Call(func=_jst_attr("convert_range_cont"),
                            args=[_name(it_name), _name(stop_name),
                                  _name(step_name)],
                            keywords=[])
            # `i = _it` first, `_it += step` last: after the loop the
            # target holds the last yielded value, exactly like Python
            bind = ast.Assign(targets=[_name(i, ast.Store())],
                              value=_name(it_name))
            inc = ast.AugAssign(target=_name(it_name, ast.Store()),
                                op=ast.Add(), value=_name(step_name))
            # inc is an UNGUARDED tail: `continue` must still advance
            # the induction variable (python for semantics)
            loop = ast.While(test=test, body=[bind] + node.body, orelse=[])
            out = list(init)
            res = self.visit_While(loop, tail_stmts=[inc])
            out.extend(res if isinstance(res, list) else [res])
            return out
        if (not node.orelse
                and isinstance(node.target, ast.Name)
                and not _contains(node.body, (ast.Return,))):
            # generic iterable — `for x in tensor` iterates the leading
            # dim (reference: loop_transformer + convert_enumerate/iter);
            # other iterables are materialized so the same indexed
            # lowering applies
            uid = self._uid()
            seq_name = f"_jst_seq_{uid}"
            it_name = f"_jst_it_{uid}"
            init = [
                ast.Assign(targets=[_name(seq_name, ast.Store())],
                           value=ast.Call(func=_jst_attr("convert_iterable"),
                                          args=[node.iter], keywords=[])),
                ast.Assign(targets=[_name(it_name, ast.Store())],
                           value=ast.Constant(0)),
            ]
            test = ast.Call(func=_jst_attr("convert_iter_cont"),
                            args=[_name(seq_name), _name(it_name)],
                            keywords=[])
            bind = ast.Assign(
                targets=[_name(node.target.id, ast.Store())],
                value=ast.Call(func=_jst_attr("convert_index"),
                               args=[_name(seq_name), _name(it_name)],
                               keywords=[]))
            inc = ast.AugAssign(target=_name(it_name, ast.Store()),
                                op=ast.Add(), value=ast.Constant(1))
            loop = ast.While(test=test, body=[bind] + node.body, orelse=[])
            out = list(init)
            res = self.visit_While(loop, tail_stmts=[inc])
            out.extend(res if isinstance(res, list) else [res])
            return out
        # untransformable for-forms stay plain python, but iterating a
        # TRACED iterable there must fail with an actionable message
        kind = ("for...else" if node.orelse
                else "return inside a nested loop"
                if _contains(node.body, (ast.Return,))
                else "for with tuple unpacking")
        self.generic_visit(node)
        node.iter = ast.Call(func=_jst_attr("reject_unsupported"),
                             args=[ast.Constant(kind), node.iter],
                             keywords=[])
        return node

    @staticmethod
    def _bind_undef(n):
        # a = _jst.local(locals(), 'a')  — UNDEF when unbound so far
        return ast.Assign(
            targets=[_name(n, ast.Store())],
            value=ast.Call(
                func=_jst_attr("local"),
                args=[ast.Call(func=_name("locals"), args=[], keywords=[]),
                      ast.Constant(n)],
                keywords=[]))


def convert_to_static(fn):
    """AST-transform `fn` (a plain function) so its data-dependent control
    flow lowers through nn.control_flow when traced. Returns a new
    function with the same signature and closure environment."""
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise TypeError(f"cannot transform {fn!r}")
    fdef.decorator_list = []  # avoid re-applying @to_static etc.
    tr = _Transformer()
    fdef.body = tr.process_body(fdef.body)
    new_tree = tree
    ast.fix_missing_locations(new_tree)
    code = compile(new_tree, f"<dy2static {fn.__qualname__}>", "exec")

    # rebuild closure: the transformed code must see the same free
    # variables; compiling standalone turns them into globals, so inject
    # the closure cells' current values into the globals namespace
    glb = dict(fn.__globals__)
    glb["_jst"] = jst
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb[name] = cell.cell_contents
            except ValueError:
                pass
    loc = {}
    exec(code, glb, loc)
    out = loc[fdef.name]
    out = functools.wraps(fn)(out)
    out.__globals__["_jst"] = jst
    if fn.__defaults__ is not None:
        out.__defaults__ = fn.__defaults__
    out._jst_transformed = True
    return out
