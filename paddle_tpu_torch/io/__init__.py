"""Datasets, samplers and the DataLoader (counterpart: ``paddle_tpu/io``).

Host-side numpy batches, assembled in the caller's process or in forked
workers that send them through shared-memory rings (``shm_worker``), handed
out as torch tensors on the loader's device (``dataloader``).
"""
from .dataset import (ChainDataset, ComposeDataset, Dataset,  # noqa: F401
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler,  # noqa: F401
                      RandomSampler, Sampler, SequenceSampler,
                      WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .shm_worker import get_worker_info  # noqa: F401
