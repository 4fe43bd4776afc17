"""Worker-side communicators (counterpart:
``paddle_tpu/distributed/ps/communicator.py``; the reference framework's
`distributed/service/communicator.h` — Communicator:197 sync,
AsyncCommunicator:348, HalfAsyncCommunicator:423, GeoCommunicator:497).

Semantics mirrored:
- sync: every worker pushes averaged grads each step, a global barrier
  orders push-before-pull, then fresh params are pulled (the reference's
  send+fetch_barrier program ops).
- async: grads are queued and pushed by a background thread; workers never
  synchronize with each other (Hogwild-style staleness is expected).
- geo: workers train LOCALLY (their own optimizer) and every `k_steps`
  push parameter DELTAS (new - base) which the server accumulates; fresh
  params are pulled after each delta push (GeoCommunicator's
  send-delta/recv cycle).

Dense variables are registered as (table_id, Parameter); sparse tables are
driven by `SparseEmbedding` which records per-step (keys, grad) pairs here.
A parameter's gradient is its torch ``grad``, read back to the host to be
pushed; pulled values are copied into the parameter in place (on its
device), so a model's tensors keep their addresses.
"""
import queue
import threading

import numpy as np
import torch

from .embedding import host_array


class _Base:
    def __init__(self, client, n_workers=1):
        self.client = client
        self.n_workers = n_workers
        self._dense = []      # (table_id, Parameter)
        self._sparse_push = []  # (table_id, keys, grads) recorded this step
        self._pending_slices = []  # (table_id, keys, slice) from lookups

    # -- registration -----------------------------------------------------
    def register_dense_param(self, table_id, param):
        self.client.register_dense(table_id, int(np.prod(param.shape)))
        self._dense.append((table_id, param))

    def record_sparse_grad(self, table_id, keys, grads):
        self._sparse_push.append((table_id, keys, grads))

    # -- lifecycle --------------------------------------------------------
    def init_params(self):
        """Adopt worker-0's initial dense values, then align every worker
        to the server copy (reference: communicator init broadcast)."""
        for table_id, p in self._dense:
            fresh = self.client.pull_dense_init(
                table_id, host_array(p, np.float32).ravel())
            self._set_param(p, fresh)

    def pull_dense(self):
        for table_id, p in self._dense:
            fresh = self.client.pull_dense(table_id)
            if fresh.size != int(np.prod(p.shape)):
                raise RuntimeError(
                    f"dense table {table_id} returned {fresh.size} values "
                    f"for a parameter of size {int(np.prod(p.shape))} — "
                    f"is the table registered on the server?")
            self._set_param(p, fresh)

    @staticmethod
    def _set_param(p, flat):
        src = torch.from_numpy(np.ascontiguousarray(flat)).reshape(p.shape)
        with torch.no_grad():
            p.copy_(src)

    @staticmethod
    def _take_grad(p):
        """``p``'s gradient as a flat float32 host array (None without
        one); the gradient is cleared."""
        if p.grad is None:
            return None
        g = host_array(p.grad, np.float32).ravel()
        p.grad = None
        return g

    def stop(self):
        pass


class SyncCommunicator(_Base):
    def step(self, optimizer=None):
        """Called after loss.backward(): push grads, barrier, pull."""
        for table_id, keys, grads in self._sparse_push:
            self.client.push_sparse_grad(table_id, keys,
                                         grads / self.n_workers)
        self._sparse_push.clear()
        for table_id, p in self._dense:
            g = self._take_grad(p)
            if g is not None:
                self.client.push_dense_grad(table_id, g / self.n_workers)
        self.client.barrier(self.n_workers,
                            timeout=600.0)  # all pushes applied ...
        self.pull_dense()
        # ... and nobody starts the next step's pushes until every worker
        # finished pulling (otherwise a fast worker's step-N+1 push lands
        # in a slow worker's step-N pull: mixed-version params)
        self.client.barrier(self.n_workers, timeout=600.0)


class AsyncCommunicator(_Base):
    """Background send thread (reference AsyncCommunicator:348 queues +
    MergeVars + RpcSend). Pulls dense params every `pull_every` steps."""

    def __init__(self, client, n_workers=1, pull_every=1):
        super().__init__(client, n_workers)
        self.pull_every = pull_every
        self._q = queue.Queue(maxsize=64)
        self._stop = threading.Event()
        self._error = None  # first send failure; re-raised on the caller
        self._thread = threading.Thread(target=self._send_loop, daemon=True)
        self._thread.start()
        self._steps = 0

    def _send_loop(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                kind, table_id, a, b = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if self._error is None:
                    if kind == "sparse":
                        self.client.push_sparse_grad(table_id, a, b)
                    else:
                        self.client.push_dense_grad(table_id, a)
            except Exception as e:  # keep draining so _q.join() never hangs
                self._error = e
            finally:
                self._q.task_done()

    def step(self, optimizer=None):
        if self._error is not None:
            raise RuntimeError(
                "async PS send thread failed") from self._error
        for table_id, keys, grads in self._sparse_push:
            self._q.put(("sparse", table_id, keys, grads))
        self._sparse_push.clear()
        for table_id, p in self._dense:
            g = self._take_grad(p)
            if g is not None:
                self._q.put(("dense", table_id, g, None))
        self._steps += 1
        if self._steps % self.pull_every == 0:
            self._drain()
            self.pull_dense()

    def _drain(self):
        self._q.join()  # blocks until the send thread called task_done
        # for every queued push — pulls then see all completed updates

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


class GeoCommunicator(_Base):
    """Local training + periodic delta sync (GeoCommunicator:497)."""

    def __init__(self, client, n_workers=1, k_steps=4, sparse_lr=0.01):
        super().__init__(client, n_workers)
        self.k_steps = k_steps
        self.sparse_lr = sparse_lr
        self._base = {}      # table_id -> flat param at last sync
        self._acc_sparse = {}  # table_id -> {key: accumulated delta}
        self._steps = 0

    def init_params(self):
        super().init_params()
        for table_id, p in self._dense:
            self._base[table_id] = host_array(p, np.float32).ravel().copy()

    def step(self, optimizer=None):
        """Called AFTER the local optimizer step (local SGD is the geo
        contract; the server only accumulates deltas)."""
        for table_id, keys, grads in self._sparse_push:
            acc = self._acc_sparse.setdefault(table_id, {})
            delta = -self.sparse_lr * grads
            for i, k in enumerate(np.asarray(keys, np.uint64).ravel()):
                cur = acc.get(int(k))
                acc[int(k)] = delta[i] if cur is None else cur + delta[i]
        self._sparse_push.clear()
        self._steps += 1
        if self._steps % self.k_steps == 0:
            self._sync()

    def _sync(self):
        for table_id, acc in self._acc_sparse.items():
            if not acc:
                continue
            keys = np.fromiter(acc.keys(), np.uint64, len(acc))
            deltas = np.stack([acc[int(k)] for k in keys])
            self.client.push_sparse_delta(table_id, keys, deltas)
            acc.clear()
        for table_id, p in self._dense:
            new = host_array(p, np.float32).ravel()
            delta = new - self._base[table_id]
            self.client.push_dense_delta(table_id, delta)
        self.pull_dense()
        for table_id, p in self._dense:
            self._base[table_id] = host_array(p, np.float32).ravel().copy()
