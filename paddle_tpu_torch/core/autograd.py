"""Eager autograd (counterpart: ``paddle_tpu/core/autograd.py``).

The reference records a tape of ``jax.vjp`` closures and walks it; the port
records nothing of its own: torch's autograd is the tape. These are the
reference's entry points over it, with its defaults: ``backward`` seeds a
non-scalar output with ones, and ``grad`` keeps the graph unless asked
(``retain_graph=None`` retains, so ``grad`` may be called again over the
same graph), returns ``Tensor``s, and with ``create_graph=True`` returns
gradients that are themselves differentiable (higher orders and gradient
penalties compose). Outputs that need no gradient are skipped, as the
reference skips outputs without a tape node.
"""
import torch

from .tensor import unwrap, wrap

__all__ = ["grad_enabled", "no_grad", "enable_grad", "backward", "grad"]

# While grad() runs, a sparse lookup's backward leaves its row gradient
# here (id(table) -> SelectedRows) and not on the table. A module global,
# not a thread-local: torch's engine runs a CUDA backward on its own threads.
_rows = [None]


def collect_rows(table, rows):
    """Keep ``table``'s row gradient ``rows`` for the running :func:`grad`
    and return True; outside one, return False."""
    sink = _rows[0]
    if sink is None:
        return False
    prior = sink.get(id(table))
    sink[id(table)] = rows if prior is None else prior.merge_add(rows)
    return True


def grad_enabled():
    return torch.is_grad_enabled()


def no_grad():
    """A context (and decorator) in which no op records a gradient."""
    return torch.no_grad()


def enable_grad():
    """A context (and decorator) in which ops record gradients again."""
    return torch.enable_grad()


def backward(tensor, grad_tensor=None, retain_graph=False):
    """Accumulate ``d tensor / d leaf`` into every leaf's ``grad``; a
    non-scalar ``tensor`` without ``grad_tensor`` is seeded with ones."""
    t = unwrap(tensor)
    if not t.requires_grad:
        return
    seed = torch.ones_like(t) if grad_tensor is None else torch.as_tensor(
        unwrap(grad_tensor), dtype=t.dtype, device=t.device)
    torch.autograd.backward(t, seed, retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """``paddle.grad``: d(outputs)/d(inputs) as ``Tensor``s, without
    touching any leaf's gradient. A table looked up only by
    ``embedding(sparse=True)`` gets its row gradient, a ``SelectedRows``,
    as the reference's ``grad`` returns it (wrapped there in a
    ``Tensor``); one reached by dense ops as well gets the dense sum. An
    input the outputs do not reach gives None with ``allow_unused``, else
    raises."""
    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = True
    pairs = [(o, g) for o, g in zip(outs, grad_outputs) if o.requires_grad]
    if pairs:
        seeds = [torch.ones_like(unwrap(o)) if g is None else torch.as_tensor(
            unwrap(g), dtype=o.dtype, device=o.device) for o, g in pairs]
        # the inputs themselves (an alias of one would be a new node)
        saved, _rows[0] = _rows[0], {}
        try:
            with torch._C.DisableTorchFunctionSubclass():
                got = torch.autograd.grad(
                    [o for o, _ in pairs], list(ins), grad_outputs=seeds,
                    retain_graph=bool(retain_graph),
                    create_graph=create_graph, allow_unused=True)
            rows = _rows[0]
        finally:
            _rows[0] = saved
    else:
        got, rows = [None] * len(ins), {}
    results = []
    for t, g in zip(ins, got):
        sparse = rows.get(id(t))
        if g is None:
            g = sparse
        else:
            if sparse is not None:
                g = g + sparse.to_dense().to(g.dtype)
            g = wrap(g if create_graph else g.detach())
        results.append(g)
    if not allow_unused and any(g is None for g in results):
        raise RuntimeError(
            "One of the differentiated tensors appears unused; pass "
            "allow_unused=True to return None for it.")
    if isinstance(inputs, (list, tuple)):
        return results
    return results[0]
