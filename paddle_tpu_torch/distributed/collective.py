"""Collectives (counterpart: ``paddle_tpu/distributed/collective.py``).

The subset that ZeRO and hybrid parallelism use, over
``torch.distributed``: NCCL on the card, gloo on the CPU. ``group`` is a
process group, or a :class:`Group` (what the fleet topology hands out), or
``None`` for the default one. Point to point (``send``, ``recv``,
``isend``, ``irecv``, ``batch_isend_irecv``) names peers by their rank in
``group``. Without an initialized process group the world is one rank
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


class Group:
    """A process group with the reference's attributes: ``ranks`` (global
    ranks in group order), ``nranks``, ``rank`` (this process's index in
    it, -1 outside), ``id`` and the mesh ``axis_name`` it spans;
    ``process_group`` is the ``torch.distributed`` group."""

    def __init__(self, process_group, ranks, axis_name=None, gid=0,
                 global_rank=None):
        self.process_group = process_group
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        me = global_rank if global_rank is not None else (
            dist.get_rank() if _world() else 0)
        self.rank = self.ranks.index(me) if me in self.ranks else -1
        self.axis_name = axis_name
        self.id = gid

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(axis={self.axis_name!r}, ranks={self.ranks}, "
                f"rank={self.rank})")


def _pg(group):
    return group.process_group if isinstance(group, Group) else group


def peer(group, i):
    """The global rank of ``group``'s rank ``i``."""
    if isinstance(group, Group):
        return group.ranks[i]
    if group is None or not _world():
        return i
    return dist.get_global_rank(group, i)


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
    return dist.get_world_size(_pg(group)) if _world() else 1


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
    dist.all_reduce(tensor, op=getattr(dist.ReduceOp, torch_op),
                    group=_pg(group))
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
        dist.broadcast(tensor, src=src, group=_pg(group))
    return tensor


@_instrumented
def barrier(group=None):
    if _world():
        dist.barrier(group=_pg(group))


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
    return _reduce_scatter(out, inp, op=dist.ReduceOp.SUM, group=_pg(group),
                           async_op=async_op)


def all_gather_flat(out, inp, group=None, async_op=False):
    """``out`` ``[n * rows, ...]`` <- every rank's ``inp`` ``[rows, ...]``
    in rank order."""
    _record("all_gather", inp.numel() * inp.element_size())
    if not _world():
        out.copy_(inp.view(out.shape))
        return None
    return _all_gather(out, inp, group=_pg(group), async_op=async_op)


# -- point to point and all-to-all (pipeline, sequence and expert parallel) ---

def isend(tensor, dst, group=None):
    """Send ``tensor`` to global rank ``dst`` without waiting; returns the
    work handle (keep ``tensor`` alive until it is waited)."""
    if not tensor.is_contiguous():
        raise ValueError("isend needs a contiguous tensor (a copy could be "
                         "freed before the send completes)")
    _record("send", tensor.numel() * tensor.element_size())
    return dist.isend(tensor, dst, group=_pg(group))


def irecv(tensor, src, group=None):
    _record("recv", tensor.numel() * tensor.element_size())
    return dist.irecv(tensor, src, group=_pg(group))


def send(tensor, dst=0, group=None, sync_op=True):
    work = isend(tensor, dst, group)
    if not sync_op:
        return work
    work.wait()


def recv(tensor, src=0, group=None, sync_op=True):
    work = irecv(tensor, src, group)
    if not sync_op:
        return work
    work.wait()
    return tensor


class P2POp:
    """One operation of :func:`batch_isend_irecv`: ``op`` is :func:`isend`
    or :func:`irecv`, ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp's op is collective.isend or "
                             "collective.irecv")
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group


def batch_isend_irecv(ops):
    """Issue every operation of ``ops`` at once (no pair of neighbours can
    deadlock on which sends first); returns their work handles."""
    p2p = []
    for o in ops:
        kind = "send" if o.op is isend else "recv"
        _record(kind, o.tensor.numel() * o.tensor.element_size())
        p2p.append(dist.P2POp(dist.isend if o.op is isend else dist.irecv,
                              o.tensor, o.peer, group=_pg(o.group)))
    return dist.batch_isend_irecv(p2p) if p2p else []


def all_to_all(out_tensor_list, in_tensor_list, group=None):
    """``out_tensor_list[j]`` <- rank j's ``in_tensor_list[r]``."""
    _record("all_to_all", sum(t.numel() * t.element_size()
                              for t in in_tensor_list))
    if not _world():
        for o, i in zip(out_tensor_list, in_tensor_list):
            o.copy_(i)
        return out_tensor_list
    dist.all_to_all(out_tensor_list, [t.contiguous() for t in in_tensor_list],
                    group=_pg(group))
    return out_tensor_list


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """The reference's argument order of :func:`all_to_all`."""
    return all_to_all(out_tensor_list, in_tensor_list, group=group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor`` <- global rank ``src``'s ``tensor_list[r]``, r this
    rank's index in ``group``."""
    _record("scatter", tensor.numel() * tensor.element_size())
    if not _world():
        tensor.copy_(tensor_list[0])
        return tensor
    dist.scatter(tensor, tensor_list if get_rank() == src else None,
                 src=src, group=_pg(group))
    return tensor


def new_group(ranks=None, backend=None, axis_name=None):
    """A :class:`Group` of ``ranks`` (default: every rank); every rank of
    the world makes every group, in one order."""
    ranks = list(range(get_world_size())) if ranks is None else list(ranks)
    pg = dist.new_group(ranks, backend=backend) if _world() else None
    return Group(pg, ranks, axis_name=axis_name)


def wait(tensor, group=None, use_calc_stream=True):
    """Order the caller after the collectives issued on ``tensor``: the
    collectives of this module run on the current stream (or are waited
    where issued), so there is nothing left to wait for."""
    return tensor


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """The reference's Megatron layer builder: a tensor-parallel layer over
    the fleet's mp group (``operation`` "linear", split on ``axis`` 1 by
    columns or 0 by rows, or "embedding"); ``x`` is not used, as in the
    reference."""
    from .fleet import meta_parallel as mp
    if operation == "linear":
        in_f, out_f = size
        if axis == 1:
            return mp.ColumnParallelLinear(in_f, out_f,
                                           weight_attr=weight_attr,
                                           has_bias=bias_attr is not False,
                                           gather_output=gather_out)
        return mp.RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                    has_bias=bias_attr is not False,
                                    input_is_parallel=not gather_out)
    if operation == "embedding":
        vocab, hidden = size
        return mp.VocabParallelEmbedding(vocab, hidden,
                                         weight_attr=weight_attr)
    raise ValueError(f"unsupported split operation: {operation}")
