"""Program rewrite passes and feed/fetch pruning (counterpart:
``paddle_tpu/static/passes.py``; the reference's ``framework/ir`` pass
registry and ``framework/prune.cc``).

A pass takes a Program and returns a NEW Program (its inputs shared, its
op list rewritten); :func:`apply_pass` clears the rewritten program's
compile cache. The reference's debug verification of each pass's output
reads ``analysis``, which is not ported (ROADMAP item 18).
"""

__all__ = ["register_pass", "apply_pass", "list_passes", "prune"]

_PASS_REGISTRY = {}


def register_pass(name):
    """Decorator: ``fn(program) -> program`` (a new Program)."""
    def deco(fn):
        _PASS_REGISTRY[name] = fn
        return fn
    return deco


def list_passes():
    return sorted(_PASS_REGISTRY)


def apply_pass(program, names):
    """Run the passes ``names`` (one name or a list) in order."""
    from .program import Program
    if isinstance(names, str):
        names = [names]
    for n in names:
        if n not in _PASS_REGISTRY:
            raise KeyError(f"unknown pass {n!r}; known: {list_passes()}")
        out = _PASS_REGISTRY[n](program)
        if isinstance(out, Program) and out is not program:
            out._compiled = {}
        program = out
    return program


@register_pass("delete_dropout_op_pass")
def delete_dropout_op_pass(prog):
    """``ir/delete_dropout_op_pass.cc``: every dropout op in its
    evaluation variant (the identity)."""
    return prog._shallow([
        op.replace(fn=op.eval_fn, eval_fn=None)
        if op.name == "dropout" and op.eval_fn is not None else op
        for op in prog.ops])


def _on_copies(fn, positions):
    """``fn`` writing copies of its arguments at ``positions`` (its
    statistics land on throwaway tensors)."""
    def run(*args, **kwargs):
        args = [a.clone() if i in positions else a
                for i, a in enumerate(args)]
        return fn(*args, **kwargs)
    run.__name__ = getattr(fn, "__name__", "op")
    return run


@register_pass("remove_stat_update_pass")
def remove_stat_update_pass(prog):
    """No op writes the running statistics (train-only bookkeeping): an op
    that writes a buffer (``batch_norm`` in training) writes copies."""
    from .program import _Slot
    ops = []
    for op in prog.ops:
        if op.mutates:
            pos = {i for i, a in enumerate(op.args)
                   if isinstance(a, _Slot) and a.idx in op.mutates}
            op = op.replace(fn=_on_copies(op.fn, pos), mutates=())
        ops.append(op)
    return prog._shallow(ops)


def prune(prog, targets):
    """The ops that ``targets`` depend on (``framework/prune.cc``), as a
    new Program. An op that writes a buffer a kept op reads is kept too
    (the running statistics of a batch norm ride with the ops that read
    them), to a fixpoint. Feeds and parameters no kept op reads leave the
    program; a slice without the loss drops the training identity."""
    roots = set()
    for t in (targets if isinstance(targets, (list, tuple)) else [targets]):
        s = prog._slot_of(t, create=False)
        if s is None:
            raise ValueError(f"target {getattr(t, 'name', t)!r} is not "
                             "recorded in this program")
        roots.add(s)
    needed = set(roots)
    while True:
        keep = set()
        for i in range(len(prog.ops) - 1, -1, -1):
            op = prog.ops[i]
            if any(s in needed for s in op.out_slots) or any(
                    s in needed for s in op.mutates):
                keep.add(i)
                needed.update(op.in_slots())
        writers = {i for i, op in enumerate(prog.ops)
                   if i not in keep and any(s in needed for s in op.mutates)}
        if not writers:
            break
        for i in writers:
            needed.update(prog.ops[i].out_slots)
    p = prog._shallow([op for i, op in enumerate(prog.ops) if i in keep])
    out_slots = {s for op in p.ops for s in op.out_slots}
    if p._loss_slot is not None and p._loss_slot not in out_slots \
            and p._loss_slot not in needed:
        p._loss_slot = None
        p._optimizer = None
    p.params = {s: t for s, t in prog.params.items() if s in needed}
    p.feed_vars = {name: v for name, v in prog.feed_vars.items()
                   if v[0] in needed}
    p._pruned_feeds = set(prog._pruned_feeds) | {
        name for name, v in prog.feed_vars.items() if v[0] not in needed}
    return p
