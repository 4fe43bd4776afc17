"""DataLoader (counterpart: ``paddle_tpu/io/dataloader.py``).

Batches are assembled on the host as numpy (``default_collate_fn``) and
come out as torch tensors on the loader's device: the card unless
``places`` says the CPU (a list of places: its first). ``num_workers=0``
assembles each batch when it is asked for; ``num_workers > 0`` with
``use_shared_memory=True`` (the default) forks that many workers that send
their batches through shared-memory rings (``shm_worker``), also when the
parent holds a live CUDA context; ``use_shared_memory=False`` takes the
reference's threaded prefetch (``_PrefetchIter``). Where the reference
forks only while no accelerator is live and else quietly takes threads,
the port forks on the card too, and a ring that cannot be built or opened
raises: no path falls back to threads or to the CPU unasked.

``prefetch_to_device=True`` moves each batch one batch ahead of its use:
on the card the batch is pinned and copied with ``non_blocking=True`` on a
side stream, and the consumer's stream waits on the copy's event when the
batch is handed out (no host synchronisation). Without it a batch is
copied when it is handed out.

``stack_steps=k`` stacks k consecutive batches along a new leading axis
(the ``[k, ...]`` super-batches of ``jit.to_static(fn, scan_steps=k)``);
it implies ``drop_last`` and drops an incomplete trailing group.
``prefetch_transform=fn`` runs ``fn(batch) -> batch`` on the host tensors
one batch ahead of their use, before the device copy.
"""
import queue
import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability import tracing as _obs
from .dataset import IterableDataset
from .sampler import BatchSampler


def default_collate_fn(batch):
    """Samples -> one batch: fields stacked leaf by leaf (numpy arrays with
    ``np.stack``, torch tensors with ``torch.stack``), Python ints int64,
    floats float32."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.detach() for b in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return np.asarray(batch)


def _map_batch(batch, leaf_fn):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_batch(b, leaf_fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_batch(v, leaf_fn) for k, v in batch.items()}
    return leaf_fn(batch)


def _host_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _stack_batches(group):
    """k batches of one structure -> one, each leaf stacked on a new
    leading axis."""
    first = group[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            _stack_batches([b[i] for b in group]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_batches([b[k] for b in group]) for k in first}
    return torch.stack([_host_tensor(b) for b in group])


class _PrefetchIter:
    """``use_shared_memory=False``: one thread assembles the batches ahead
    of their use (the reference's threaded prefetch)."""

    _END = object()

    def __init__(self, loader):
        self.loader = loader
        self.q = queue.Queue(maxsize=max(2, loader.prefetch_factor))
        self.error = None
        self.thread = threading.Thread(target=self._produce, daemon=True)
        self.thread.start()

    def _produce(self):
        try:
            loader = self.loader
            if isinstance(loader.dataset, IterableDataset):
                batch = []
                for sample in loader.dataset:
                    batch.append(sample)
                    if len(batch) == loader.batch_size:
                        self.q.put(loader.collate_fn(batch))
                        batch = []
                if batch and not loader.drop_last:
                    self.q.put(loader.collate_fn(batch))
            else:
                for indices in loader.batch_sampler:
                    self.q.put(loader.collate_fn(
                        [loader.dataset[i] for i in indices]))
        except BaseException as e:  # raised on the consumer's side
            self.error = e
        finally:
            self.q.put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        if not _obs.enabled("dataloader"):
            item = self.q.get()
        else:
            with _obs.trace_span("dataloader/wait", cat="dataloader",
                                 queue_depth=self.q.qsize()):
                t0 = _obs.now_ns()
                item = self.q.get()
                wait = _obs.now_ns() - t0
            _obs.count("dataloader_wait_ns", wait)
            if item is not self._END:
                _obs.count("dataloader_batches")
        if item is self._END:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return self.loader._to_output(item)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 shm_capacity=64 << 20, prefetch_to_device=False,
                 stack_steps=None, prefetch_transform=None):
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = resolve_device(places)
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.shm_capacity = shm_capacity
        self.prefetch_to_device = prefetch_to_device
        self.prefetch_transform = prefetch_transform
        self.last_stats = None  # the ring's counts of the last epoch
        if stack_steps is not None and int(stack_steps) < 1:
            raise ValueError(f"stack_steps must be >= 1, got {stack_steps}")
        self.stack_steps = int(stack_steps) if stack_steps else None
        if self.stack_steps:
            drop_last = True  # a short batch cannot stack with full ones
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif not isinstance(dataset, IterableDataset):
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
        else:
            self.batch_sampler = None

    def _to_output(self, batch):
        """A collated batch as host torch tensors (the device copy comes
        last, in ``__iter__``)."""
        return _map_batch(batch, _host_tensor)

    def __iter__(self):
        it = self._base_iter()
        if self.stack_steps:
            it = self._stack_iter(it)
        if self.prefetch_transform is not None or self.prefetch_to_device:
            return self._prefetch_iter(it)
        if self.device.type == "cuda":
            return (self._to_device(b) for b in it)
        return it

    def _base_iter(self):
        if self.num_workers == 0:
            return self._sync_iter()
        if self.use_shared_memory:
            from .shm_worker import MultiprocessIter
            return MultiprocessIter(self)
        return _PrefetchIter(self)

    def _stack_iter(self, it):
        group = []
        for batch in it:
            group.append(batch)
            if len(group) == self.stack_steps:
                yield _stack_batches(group)
                group = []

    def _to_device(self, batch):
        return _map_batch(batch, lambda t: t.to(self.device))

    def _copy_ahead(self, batch, stream):
        """Issue the batch's copy to the card on ``stream`` from pinned
        memory; returns (the device batch, the copy's event)."""
        with torch.cuda.stream(stream):
            out = _map_batch(batch, lambda t: t.pin_memory().to(
                self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _handed_out(self, pending):
        batch, event = pending
        if event is None:
            return batch
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        # memory made on the side stream is used on the consumer's
        _map_batch(batch, lambda t: t.record_stream(current))
        return batch

    def _prefetch_iter(self, it):
        """Run ``prefetch_transform`` and start the device copy of batch
        i + 1 before batch i is handed out."""
        on_card = self.prefetch_to_device and self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if on_card else None
        pending = None
        for batch in it:
            if self.prefetch_transform is not None:
                batch = self.prefetch_transform(batch)
            if on_card:
                placed = self._copy_ahead(batch, stream)
            elif self.device.type == "cuda":
                placed = (self._to_device(batch), None)
            else:
                placed = (batch, None)
            if pending is not None:
                yield self._handed_out(pending)
            pending = placed
        if pending is not None:
            yield self._handed_out(pending)

    def _emit_sync(self, batch):
        if not _obs.enabled("dataloader"):
            return self._to_output(self.collate_fn(batch))
        with _obs.trace_span("dataloader/batch", cat="dataloader",
                             batch_size=len(batch)):
            t0 = _obs.now_ns()
            out = self._to_output(self.collate_fn(batch))
            _obs.count("dataloader_wait_ns", _obs.now_ns() - t0)
            _obs.count("dataloader_batches")
        return out

    def _sync_iter(self):
        if isinstance(self.dataset, IterableDataset):
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self._emit_sync(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self._emit_sync(batch)
        else:
            for indices in self.batch_sampler:
                yield self._emit_sync([self.dataset[i] for i in indices])

    def __len__(self):
        if self.batch_sampler is not None:
            n = len(self.batch_sampler)
            return n // self.stack_steps if self.stack_steps else n
        raise TypeError("IterableDataset DataLoader has no len()")

    def __call__(self):
        return self.__iter__()
