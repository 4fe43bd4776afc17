"""Multiprocess DataLoader workers over the native shared-memory ring
(counterpart: ``paddle_tpu/io/shm_worker.py``).

Each forked worker owns one single-producer ring in POSIX shared memory
(``_native``'s ``pt_ring_*``); its batches are pickled (protocol 5) into
the ring and the parent reads the rings round-robin, so the global order of
the batches is that of one process. The order of the reference is kept:
the epoch's batch index lists are materialised in the parent (the
sampler's draws happen there, once), the epoch seed is one draw of the
parent's ``np.random``, each worker seeds ``np.random`` with ``epoch_seed
+ worker_id`` (an ``IterableDataset``'s workers all with ``epoch_seed``:
each replays the stream and keeps batches ``b % num_workers == id``), and
the merge is round-robin. A worker that raises sends its error through its
ring and the parent raises it; a worker that dies is found by ``waitpid``
when its ring has been silent for a poll slice (``POLL_MS``).

The parent may hold a live CUDA context: the workers are forked all the
same, as torch's own loader forks, and touch only numpy and torch on the
CPU, with one thread. A worker hides the card from itself
(``CUDA_VISIBLE_DEVICES`` emptied before anything initialises CUDA there),
so a dataset or transform that reaches CUDA raises in the worker, and the
parent raises that error. A ring that cannot be created or opened raises;
nothing falls back to threads.

The parent's side counts what it moved (``MultiprocessIter.stats``, also
the loader's ``last_stats``): the batches, the bytes, the nanoseconds it
waited for a worker's next batch and the nanoseconds it spent copying
batches out of the rings and unpickling them. With tracing on for
``dataloader`` the wait is also the ``dataloader_wait_ns`` counter that
``observability.StepTimer`` reads as its ``data_wait_frac``.
"""
import ctypes
import os
import pickle
import signal
import time
import traceback

import numpy as np
import torch

from .. import _native
from ..observability import tracing as _obs

POLL_MS = 5000  # a dead worker is found within one slice of silence

_WORKER_INFO = None


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    """Inside a worker process its ``WorkerInfo`` (``id``,
    ``num_workers``, ``dataset``); None in the parent."""
    return _WORKER_INFO


class _RingWriter:
    def __init__(self, name):
        L = _native.lib()
        self._L = L
        self._ring = L.pt_ring_open(name.encode())
        if not self._ring:
            raise RuntimeError(f"worker could not open shm ring {name}")

    def send(self, obj, timeout_ms=600000):
        data = pickle.dumps(obj, protocol=5)
        rc = self._L.pt_ring_write(self._ring, data, len(data), timeout_ms)
        if rc == -3:
            raise RuntimeError(
                f"batch of {len(data)} bytes exceeds shm ring capacity; "
                f"raise DataLoader(shm_capacity=...)")
        if rc != 0:
            raise RuntimeError(f"shm ring write failed (rc={rc})")

    def close(self):
        self._L.pt_ring_close_producer(self._ring)
        self._L.pt_ring_free(self._ring, 0)


class _RingReader:
    def __init__(self, name, capacity):
        L = _native.lib()
        self._L = L
        self._name = name
        self._ring = L.pt_ring_create(name.encode(), capacity)
        if not self._ring:
            raise RuntimeError(
                f"could not create shm ring {name} of {capacity} bytes "
                f"(shm_open, ftruncate or mmap failed)")

    def wait(self, timeout_ms):
        """The next message's length; raises TimeoutError or EOFError."""
        n = self._L.pt_ring_next_len(self._ring, timeout_ms)
        if n == -1:
            raise TimeoutError
        if n == -2:
            raise EOFError
        return int(n)

    def read(self, n):
        """Pop the next message of ``n`` bytes and unpickle it (into a
        writable buffer, so its arrays come back writable)."""
        buf = bytearray(n)
        got = self._L.pt_ring_read(self._ring,
                                   (ctypes.c_char * n).from_buffer(buf), n)
        if got != n:
            raise EOFError
        return pickle.loads(buf)

    def close(self, unlink=True):
        if self._ring:
            self._L.pt_ring_free(self._ring, 1 if unlink else 0)
            self._ring = None


def _to_numpy_tree(obj):
    """What crosses the ring: numpy, never a torch tensor (a CUDA tensor
    raises here, in the worker)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(_to_numpy_tree(o) for o in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_tree(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    return obj


def _worker_loop(loader, worker_id, num_workers, ring_name, epoch_seed,
                 batches):
    """The forked child's body: this worker's share of the batches, in
    order. ``batches`` is its slice of the parent's index lists (None for
    an ``IterableDataset``)."""
    global _WORKER_INFO
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the card is the parent's
    torch.set_num_threads(1)
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the parent handles ^C
    _WORKER_INFO = WorkerInfo(worker_id, num_workers, loader.dataset)
    if batches is None:
        np.random.seed(epoch_seed)  # every worker replays one stream
    else:
        np.random.seed(epoch_seed + worker_id)
    writer = _RingWriter(ring_name)

    def _collate(samples):
        return _to_numpy_tree(loader.collate_fn(
            [_to_numpy_tree(s) for s in samples]))

    try:
        if loader.worker_init_fn is not None:
            loader.worker_init_fn(worker_id)
        if batches is None:
            batch, b = [], 0
            for sample in loader.dataset:
                batch.append(sample)
                if len(batch) == loader.batch_size:
                    if b % num_workers == worker_id:
                        writer.send(_collate(batch))
                    batch = []
                    b += 1
            if batch and not loader.drop_last and b % num_workers == worker_id:
                writer.send(_collate(batch))
        else:
            for indices in batches:
                writer.send(_collate([loader.dataset[i] for i in indices]))
    except Exception as e:  # sent to the parent, which raises it
        try:
            writer.send(("__worker_error__", worker_id,
                         f"{e!r}\n{traceback.format_exc()}"))
        except RuntimeError:
            pass  # the ring is closed or full: the parent sees the exit
    finally:
        writer.close()


class MultiprocessIter:
    """The parent's iterator: the workers' rings merged round-robin."""

    def __init__(self, loader):
        from .dataset import IterableDataset
        _native.lib()  # raises NativeBuildError when it cannot be built
        self.loader = loader
        self.num_workers = loader.num_workers
        # timeout=0 means no deadline (paddle's convention); the rings are
        # still polled in slices, so a dead worker is found
        self.timeout_ms = int(loader.timeout * 1000) if loader.timeout else None
        self.stats = {"batches": 0, "bytes": 0, "wait_ns": 0, "read_ns": 0}
        loader.last_stats = self.stats
        # one draw of the parent's RNG: a fresh shuffle every epoch
        self._epoch_seed = int(np.random.randint(0, 2 ** 31 - 1))
        if isinstance(loader.dataset, IterableDataset):
            self._batches = None
        else:
            self._batches = [list(ix) for ix in loader.batch_sampler]
        self._readers, self._pids = [], []
        self._exhausted = [False] * self.num_workers
        self._next_worker = 0
        base = f"/ptt_dl_{os.getpid()}_{id(self) & 0xffffff}"
        try:
            for w in range(self.num_workers):
                self._readers.append(
                    _RingReader(f"{base}_{w}", loader.shm_capacity))
        except BaseException:
            self._shutdown()
            raise
        for w in range(self.num_workers):
            pid = os.fork()
            if pid == 0:
                for r in self._readers:
                    r.close(unlink=False)  # the parent's mappings
                try:
                    _worker_loop(loader, w, self.num_workers, f"{base}_{w}",
                                 self._epoch_seed,
                                 None if self._batches is None
                                 else self._batches[w::self.num_workers])
                finally:
                    os._exit(0)
            self._pids.append(pid)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            w = self._next_worker
            if all(self._exhausted):
                self._shutdown()
                raise StopIteration
            if self._exhausted[w]:
                self._next_worker = (w + 1) % self.num_workers
                continue
            try:
                obj = self._recv_polling(w)
            except EOFError:
                self._exhausted[w] = True
                self._next_worker = (w + 1) % self.num_workers
                continue
            if (isinstance(obj, tuple) and len(obj) == 3
                    and obj[0] == "__worker_error__"):
                self._shutdown()
                raise RuntimeError(
                    f"DataLoader worker {obj[1]} failed: {obj[2]}")
            self._next_worker = (w + 1) % self.num_workers
            return self.loader._to_output(obj)

    def _recv_polling(self, w):
        """Worker w's next message, waited for in poll slices: a dead worker
        is found within a slice; a slow one only fails past an explicit
        timeout."""
        waited = 0
        t0 = time.perf_counter_ns()
        while True:
            slice_ms = POLL_MS
            if self.timeout_ms is not None:
                slice_ms = min(slice_ms, self.timeout_ms - waited)
            try:
                n = self._readers[w].wait(max(1, slice_ms))
                break
            except TimeoutError:
                waited += slice_ms
                self._check_worker(w)  # raises if the worker died
                if self.timeout_ms is not None and waited >= self.timeout_ms:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader worker {w} timed out after "
                        f"{self.timeout_ms} ms")
        t1 = time.perf_counter_ns()
        obj = self._readers[w].read(n)
        self.stats["wait_ns"] += t1 - t0
        self.stats["read_ns"] += time.perf_counter_ns() - t1
        self.stats["bytes"] += n
        self.stats["batches"] += 1
        _obs.count("dataloader_wait_ns", t1 - t0, cat="dataloader")
        _obs.count("dataloader_batches", cat="dataloader")
        return obj

    def _check_worker(self, w):
        try:
            pid, status = os.waitpid(self._pids[w], os.WNOHANG)
        except ChildProcessError:  # reaped on an earlier poll
            return
        if pid != 0 and not (os.WIFEXITED(status)
                             and os.WEXITSTATUS(status) == 0):
            self._shutdown()
            raise RuntimeError(
                f"DataLoader worker {w} (pid {pid}) exited unexpectedly "
                f"(status {status})")

    def _shutdown(self):
        for pid in self._pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        for pid in self._pids:
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
        for r in self._readers:
            r.close(unlink=True)
        self._pids, self._readers = [], []

    def __del__(self):
        self._shutdown()
