"""PS-routed sparse embedding (counterpart:
``paddle_tpu/distributed/ps/embedding.py``; the reference framework's
`operators/pscore/distributed_lookup_table_op.cc` + the
`paddle.static.nn.sparse_embedding` front-end).

The uncached path: the forward pulls the batch's unique rows from the
sparse table, puts them on the ids' device as a leaf that requires grad,
and gathers from it; the slice is recorded so that, after
``loss.backward()``, :func:`flush_sparse_grads` reads its gradient back
and hands it to the communicator, which pushes it — the eager analog of
the reference's lookup-op + send-op pair.
"""
import numpy as np
import torch

from ...core.device import resolve_device
from ...core.tensor import boundary, unwrap
from ...nn.layer.layers import Layer


def host_array(x, dtype=None):
    """``x`` (a tensor on any device, a ``Tensor`` or array-like) as a
    numpy array."""
    if isinstance(x, torch.Tensor):
        x = unwrap(x).detach().cpu().numpy()
    x = np.asarray(x)
    return x if dtype is None else x.astype(dtype)


def _lookup(ids, table_id, communicator, device=None):
    # tensor ids keep their device; host ids go to ``device``, the card
    # unless the caller asks for the CPU (``core.device``'s rule)
    device = unwrap(ids).device if isinstance(ids, torch.Tensor) \
        else resolve_device(device)
    ids_np = host_array(ids, np.int64)
    shape = ids_np.shape
    uniq, inv = np.unique(ids_np.ravel(), return_inverse=True)
    vals = communicator.client.pull_sparse(table_id, uniq.astype(np.uint64))
    grad = torch.is_grad_enabled()
    slice_t = torch.from_numpy(vals).to(device).requires_grad_(grad)
    inv_t = torch.from_numpy(inv.reshape(-1).astype(np.int64)).to(device)
    out = slice_t.index_select(0, inv_t).reshape(*shape, vals.shape[1])
    if grad:
        # forward-only loops (eval/serving under no_grad) must not grow
        # the pending list — nothing will ever flush it
        communicator._pending_slices.append((table_id, uniq, slice_t))
    return out


distributed_lookup_table = boundary(_lookup,
                                    op_name="distributed_lookup_table")
distributed_lookup_table.__doc__ = (
    """Functional lookup: ``[..., dim]`` embeddings for the int ``ids``,
    differentiable with respect to the pulled rows. The result lies on the
    ids' device when they are a tensor, else on ``device`` (the card
    unless ``"cpu"`` is asked for).""")


def flush_sparse_grads(communicator):
    """Collect grads of this step's pulled slices into the communicator
    (called by the DistributedOptimizer step, after backward)."""
    for table_id, keys, slice_t in communicator._pending_slices:
        if slice_t.grad is not None:
            communicator.record_sparse_grad(
                table_id, keys.astype(np.uint64),
                host_array(slice_t.grad, np.float32))
    communicator._pending_slices = []


class SparseEmbedding(Layer):
    """Embedding whose table lives on the parameter servers. Host ids
    (numpy, lists) are looked up onto ``device``: the card unless
    ``"cpu"``; tensor ids keep their own device."""

    _next_table_id = 1000  # sparse tables: 1000+; dense vars: 0..999

    def __init__(self, size, table_id=None, init_range=0.1, name=None,
                 device=None):
        super().__init__()
        self._device = device
        num, dim = size
        self.num_embeddings = num
        self.embedding_dim = dim
        self.init_range = init_range
        if table_id is None:
            table_id = SparseEmbedding._next_table_id
            SparseEmbedding._next_table_id += 1
        self.table_id = table_id
        _sparse_registry.append(self)
        self._communicator = None

    def bind(self, communicator):
        self._communicator = communicator
        communicator.client.register_sparse(self.table_id,
                                            self.embedding_dim)

    def forward(self, ids):
        if self._communicator is None:
            raise RuntimeError(
                "SparseEmbedding is not bound to a communicator — call "
                "fleet.init_worker() (or .bind(communicator)) first")
        return _lookup(ids, self.table_id, self._communicator,
                       self._device)


_sparse_registry = []  # all SparseEmbedding layers constructed this process


def sparse_tables():
    return list(_sparse_registry)


def reset_registry():
    _sparse_registry.clear()
    SparseEmbedding._next_table_id = 1000


def _mix64(x):
    """splitmix64's finalizer over uint64 arrays (ps_service.cc mix64)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


def _row_hashes(seed, keys, i):
    """The server's hash of column ``i`` of each key's row."""
    return _mix64(np.uint64(seed) ^ _mix64(
        keys * np.uint64(1315423911) + np.uint64(i)))


def deterministic_init(seed, keys, dim, init_range):
    """Python mirror of the server's per-key splitmix64 row initializer
    (ps_service.cc mix64) — lets local/parity tests reproduce server-side
    embedding initialization exactly."""
    keys = np.asarray(keys, np.uint64).ravel()
    out = np.empty((keys.size, dim), np.float32)
    with np.errstate(over="ignore"):
        for i in range(dim):
            h = _row_hashes(seed, keys, i)
            u = (h >> np.uint64(11)).astype(np.float64) / 9007199254740992.0
            out[:, i] = (2.0 * u - 1.0) * init_range
    return out


def server_init_rows(seed, keys, dim, init_range):
    """The server's per-key initializer in the server's own float32
    arithmetic (``ps_service.cc``'s ``SparseTable::row``): bitwise the rows
    a fresh server returns. :func:`deterministic_init` (the reference's
    mirror) computes in float64 and may differ from it by one rounding."""
    keys = np.asarray(keys, np.uint64).ravel()
    out = np.zeros((keys.size, dim), np.float32)
    if not init_range > 0:
        return out
    scale = np.float32(1.0 / 9007199254740992.0)
    r = np.float32(init_range)
    with np.errstate(over="ignore"):
        for i in range(dim):
            h = _row_hashes(seed, keys, i)
            # h >> 11 < 2^53: exact in float64, one rounding to float32
            u = (h >> np.uint64(11)).astype(np.float64).astype(np.float32)
            out[:, i] = (np.float32(2) * (u * scale) - np.float32(1)) * r
    return out
