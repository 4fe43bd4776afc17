"""Collectives (counterpart: ``paddle_tpu/distributed/collective.py``).

The subset that ZeRO and its tests use, over ``torch.distributed``: NCCL on
the card, gloo on the CPU. ``group`` is a process group (``None``: the
default one). Without an initialized process group the world is one rank
and each collective is its identity, as in the reference's single-process
eager path.

Every collective counts its calls and payload bytes by kind
(:func:`counts`, :func:`reset_counts`; the reference's ``_instrumented``).
A call counts where Python issues it: under CUDA-graph capture once, and a
replay of the graph adds nothing.
"""
import functools

import torch
import torch.distributed as dist

_counts = {}


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"

    ALL = frozenset({"sum", "max", "min", "prod", "avg"})


_TORCH_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "prod": "PRODUCT"}


def _validate_reduce_op(op, supported=None):
    """Reject unknown or unsupported ReduceOp values with a clear error."""
    if op not in ReduceOp.ALL:
        raise ValueError(
            f"unknown ReduceOp {op!r}; expected one of "
            f"{sorted(ReduceOp.ALL)} (use the ReduceOp.* constants)")
    if supported is not None and op not in supported:
        raise NotImplementedError(
            f"ReduceOp {op!r} is not supported by this collective "
            f"(supported: {sorted(supported)})")


def _record(kind, nbytes):
    calls, total = _counts.get(kind, (0, 0))
    _counts[kind] = (calls + 1, total + int(nbytes))


def counts():
    """{kind: (calls, payload bytes)} since the last :func:`reset_counts`."""
    return dict(_counts)


def reset_counts():
    _counts.clear()


def _instrumented(fn):
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        nbytes = 0
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, torch.Tensor):
                nbytes = a.numel() * a.element_size()
                break
            if isinstance(a, (list, tuple)) and a and isinstance(
                    a[0], torch.Tensor):
                nbytes = sum(t.numel() * t.element_size() for t in a)
                break
        _record(name, nbytes)
        return fn(*args, **kwargs)

    return wrapper


def _world():
    return dist.is_available() and dist.is_initialized()


def _size(group):
    return dist.get_world_size(group) if _world() else 1


# torch 2.13 renames the flat collectives (the old names warn); the card's
# torch may predate the new ones
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place: every rank's ``tensor`` becomes the reduction over the
    group (AVG: the sum over the group's size). Returns ``tensor``."""
    _validate_reduce_op(op)
    _record("all_reduce", tensor.numel() * tensor.element_size())
    if not _world():
        return tensor
    torch_op = _TORCH_OPS["sum" if op == ReduceOp.AVG else op]
    dist.all_reduce(tensor, op=getattr(dist.ReduceOp, torch_op), group=group)
    if op == ReduceOp.AVG:
        tensor.div_(_size(group))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every rank's ``tensor`` to ``tensor_list``, in rank order."""
    n = _size(group)
    flat = torch.empty(n * tensor.numel(), dtype=tensor.dtype,
                       device=tensor.device)
    all_gather_flat(flat, tensor.contiguous().view(-1), group)
    tensor_list.extend(t.view(tensor.shape) for t in flat.chunk(n))
    return tensor_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    return all_reduce(tensor, op=op, group=group)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Sum the per-rank lists elementwise and keep this rank's entry in
    ``tensor`` (one list entry per rank of the group)."""
    _validate_reduce_op(op, supported={ReduceOp.SUM})
    if tensor_list:
        shapes = [tuple(t.shape) for t in tensor_list]
        dtypes = [t.dtype for t in tensor_list]
        for i, (s, d) in enumerate(zip(shapes, dtypes)):
            if s != shapes[0] or d != dtypes[0]:
                raise ValueError(
                    f"reduce_scatter needs identical per-rank shapes/"
                    f"dtypes; entry 0 is {shapes[0]}/{dtypes[0]} but "
                    f"entry {i} is {s}/{d}")
    nranks = _size(group)
    if len(tensor_list) != nranks:
        raise ValueError(
            f"reduce_scatter needs len(tensor_list) == group size "
            f"({nranks}), got {len(tensor_list)}")
    with torch.no_grad():
        flat = torch.empty(tensor.numel(), dtype=tensor.dtype,
                           device=tensor.device)
        reduce_scatter_flat(flat, torch.stack(tensor_list).reshape(-1),
                            group)
        tensor.copy_(flat.view(tensor.shape))
    return tensor


@_instrumented
def broadcast(tensor, src=0, group=None, sync_op=True):
    if _world():
        dist.broadcast(tensor, src=src, group=group)
    return tensor


@_instrumented
def barrier(group=None):
    if _world():
        dist.barrier(group=group)


def get_rank():
    return dist.get_rank() if _world() else 0


def get_world_size():
    return _size(None)


# -- the flat collectives: the one path each kind is issued by ----------------
# ``async_op=True`` returns the work handle (``wait()`` orders the caller's
# stream after it), None otherwise.

def reduce_scatter_flat(out, inp, group=None, async_op=False):
    """``out`` <- this rank's ``[rows/n, ...]`` block of the sum over the
    group of every rank's ``inp`` ``[rows, ...]``."""
    _record("reduce_scatter", inp.numel() * inp.element_size())
    if not _world():
        out.copy_(inp.view(out.shape))
        return None
    return _reduce_scatter(out, inp, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)


def all_gather_flat(out, inp, group=None, async_op=False):
    """``out`` ``[n * rows, ...]`` <- every rank's ``inp`` ``[rows, ...]``
    in rank order."""
    _record("all_gather", inp.numel() * inp.element_size())
    if not _world():
        out.copy_(inp.view(out.shape))
        return None
    return _all_gather(out, inp, group=group, async_op=async_op)
