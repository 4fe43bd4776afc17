"""Samplers (counterpart: ``paddle_tpu/io/sampler.py``).

The random samplers draw from the global ``np.random`` exactly as the
reference does (``permutation``, ``randint``, ``choice``), so one
``np.random.seed`` gives both packages the same index lists.
``DistributedBatchSampler`` shuffles with ``RandomState(epoch)`` and takes
this rank's every ``nranks``-th index; without explicit ``num_replicas``
and ``rank`` they are the default process group's (1 and 0 without one),
where the reference reads jax's process count and index.
"""
import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _process_view():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shards the index space over data-parallel ranks: the index list
    padded with its head to a multiple of ``num_replicas``, every
    ``num_replicas``-th index from ``rank``."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        world, me = _process_view()
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]
        local = indices[self.local_rank::self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
