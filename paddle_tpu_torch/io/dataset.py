"""Datasets (counterpart: ``paddle_tpu/io/dataset.py``).

Map-style datasets index with ``[i]`` and have a length; an
``IterableDataset`` streams. ``TensorDataset`` slices each of its arrays
(numpy, or torch tensors left on their device) at an index;
``random_split`` permutes with the global ``np.random``, as the reference
does, so one ``np.random.seed`` gives both packages the same split.
"""
import numpy as np
import torch


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] if isinstance(t, torch.Tensor)
                     else np.asarray(t)[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Samples of several datasets of one length side by side, each
    sample's fields flattened into one tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if len({len(d) for d in self.datasets}) != 1:
            raise ValueError("the datasets must share one length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, tuple):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths from one permutation of
    the global ``np.random`` (``generator`` is taken and unused, as in the
    reference)."""
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(f"lengths sum to {total}, the dataset holds "
                         f"{len(dataset)}")
    perm = np.random.permutation(total)
    out = []
    offset = 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
