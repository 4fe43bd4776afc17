"""``io`` of the port against the reference's, on the CPU.

- The samplers and ``random_split`` give the reference's index lists under
  one ``np.random.seed`` (exactly).
- ``DataLoader`` over the synthetic Cifar10 with a ``Compose`` of
  ``RandomCrop``, the flips, ``ToTensor`` and ``Normalize``, shuffled, at
  ``num_workers`` 0 and 2 (the reference forks its ring workers on the CPU
  too): every batch bitwise the reference's, batch for batch; so too an
  ``IterableDataset`` split over workers, ``drop_last``, ``stack_steps``
  and ``prefetch_transform``.
- ``use_shared_memory=False`` takes the threaded path and gives the same
  batches as ``num_workers=0``; a ring that cannot be created raises (no
  fallback); a worker that raises surfaces its error; a worker killed by a
  signal is found within a poll slice; a worker sees ``get_worker_info``,
  one thread and no card; the parent sees no worker info.
- Every test leaves no worker process behind.
"""
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu import io as R
from paddle_tpu.vision import datasets as RD
from paddle_tpu.vision import transforms as RT
from paddle_tpu_torch import io as T
from paddle_tpu_torch.io import shm_worker
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import transforms as TT


def _children():
    pids = set()
    for task in Path(f"/proc/{os.getpid()}/task").iterdir():
        try:
            pids |= {int(p) for p in (task / "children").read_text().split()}
        except OSError:
            continue
    return pids


@pytest.fixture(autouse=True)
def _no_worker_left():
    before = _children()
    yield
    assert _children() - before == set()


class Rows(T.Dataset):
    """Index i -> (a float row of i, the int i)."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full(3, i, np.float32), np.int64(i)


# -- samplers ------------------------------------------------------------------

SAMPLERS = {
    "sequence": lambda M, ds: M.SequenceSampler(ds),
    "random": lambda M, ds: M.RandomSampler(ds),
    "random-replacement": lambda M, ds: M.RandomSampler(
        ds, replacement=True, num_samples=40),
    "random-num_samples": lambda M, ds: M.RandomSampler(ds, num_samples=7),
    "weighted": lambda M, ds: M.WeightedRandomSampler(
        np.arange(1, 24, dtype=np.float64), 30),
    "weighted-no-replacement": lambda M, ds: M.WeightedRandomSampler(
        np.arange(1, 24, dtype=np.float64), 10, replacement=False),
    "batch": lambda M, ds: M.BatchSampler(ds, batch_size=5),
    "batch-shuffle-drop_last": lambda M, ds: M.BatchSampler(
        ds, shuffle=True, batch_size=5, drop_last=True),
    "distributed-rank0": lambda M, ds: M.DistributedBatchSampler(
        ds, 4, num_replicas=2, rank=0, shuffle=True),
    "distributed-rank1-drop_last": lambda M, ds: M.DistributedBatchSampler(
        ds, 4, num_replicas=2, rank=1, shuffle=True, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_gives_the_reference_indices(name):
    ds = Rows()
    got_s, want_s = SAMPLERS[name](T, ds), SAMPLERS[name](R, ds)
    for epoch in range(2):
        if hasattr(got_s, "set_epoch"):
            got_s.set_epoch(epoch)
            want_s.set_epoch(epoch)
        np.random.seed(epoch)
        got = list(got_s)
        np.random.seed(epoch)
        assert got == list(want_s)
        assert len(got_s) == len(want_s)


def test_random_split_and_the_datasets():
    np.random.seed(3)
    got = T.random_split(Rows(), [10, 13])
    np.random.seed(3)
    want = R.random_split(Rows(), [10, 13])
    assert [g.indices for g in got] == [w.indices for w in want]
    with pytest.raises(ValueError):
        T.random_split(Rows(), [10, 10])
    a = np.arange(12).reshape(6, 2)
    td = T.TensorDataset([a, torch.arange(6)])
    assert len(td) == 6 and td[4][0].tolist() == [8, 9] and int(td[4][1]) == 4
    cd = T.ComposeDataset([Rows(6), T.TensorDataset([a])])
    assert len(cd[2]) == 3 and cd[2][2].tolist() == [4, 5]
    chain = T.ChainDataset([range(3), range(2)])
    assert [v for v in chain] == [0, 1, 2, 0, 1]
    assert len(T.Subset(Rows(), [1, 5])) == 2


# -- DataLoader against the reference ----------------------------------------------

def _cifar(M_ds, M_tf):
    tf = M_tf.Compose([M_tf.RandomCrop(28, padding=2),
                       M_tf.RandomHorizontalFlip(),
                       M_tf.RandomVerticalFlip(0.3), M_tf.ToTensor(),
                       M_tf.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4])])
    ds = M_ds.Cifar10(mode="train", transform=tf)
    ds.images, ds.labels = ds.images[:200], ds.labels[:200]
    return ds


def _epochs(make, seed, epochs=2):
    out = []
    np.random.seed(seed)
    loader = make()
    for _ in range(epochs):
        out.append([tuple(np.asarray(t.numpy()) for t in b) for b in loader])
    return out


def _equal(got, want):
    assert len(got) == len(want)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch)
        for g, w in zip(g_epoch, w_epoch):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype or (a.dtype, b.dtype) == (
                    np.int64, np.int32)
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataloader_batches_are_the_references(num_workers):
    kw = dict(batch_size=32, shuffle=True, num_workers=num_workers)
    got = _epochs(lambda: T.DataLoader(_cifar(TD, TT), places="cpu", **kw), 9)
    want = _epochs(lambda: R.DataLoader(_cifar(RD, RT), **kw), 9)
    _equal(got, want)
    assert got[0][0][0].shape == (32, 3, 28, 28)
    assert len(got[0]) == 7  # 200 = 6 x 32 + 8: the short batch kept


class Stream(T.IterableDataset):
    def __init__(self, n=23):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full(2, i, np.float32) + np.float32(np.random.rand())


class RefStream(Stream, R.IterableDataset):
    pass


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_iterable_dataset_split_over_workers(num_workers, drop_last):
    kw = dict(batch_size=4, num_workers=num_workers, drop_last=drop_last)
    got = _epochs(lambda: T.DataLoader(Stream(), places="cpu", **kw), 4, 1)
    want = _epochs(lambda: R.DataLoader(RefStream(), **kw), 4, 1)
    _equal([[b if isinstance(b, tuple) else (b,) for b in e] for e in got],
           [[b if isinstance(b, tuple) else (b,) for b in e] for e in want])
    assert len(got[0]) == (5 if drop_last else 6)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_stack_steps_and_prefetch_transform(num_workers):
    def add_one(batch):
        return tuple(t + 1 for t in batch)

    kw = dict(batch_size=3, shuffle=True, num_workers=num_workers,
              stack_steps=2, prefetch_transform=add_one)
    got = _epochs(lambda: T.DataLoader(Rows(), places="cpu", **kw), 5, 1)
    want = _epochs(lambda: R.DataLoader(Rows(), **kw), 5, 1)
    _equal(got, want)
    assert got[0][0][0].shape == (2, 3, 3) and len(got[0]) == 3
    assert len(T.DataLoader(Rows(), places="cpu", **kw)) == 3


def test_threaded_path_gives_the_same_batches():
    kw = dict(batch_size=4, shuffle=True)
    got = _epochs(lambda: T.DataLoader(Rows(), places="cpu", num_workers=2,
                                       use_shared_memory=False, **kw), 2, 1)
    want = _epochs(lambda: T.DataLoader(Rows(), places="cpu", **kw), 2, 1)
    _equal(got, want)


def test_default_collate_fn_matches_the_reference():
    samples = [({"a": np.ones(2, np.float32) * i}, i, 0.5 * i)
               for i in range(3)]
    got, want = T.default_collate_fn(samples), R.default_collate_fn(samples)
    np.testing.assert_array_equal(got[0]["a"], want[0]["a"])
    assert got[1].dtype == want[1].dtype == np.int64
    assert got[2].dtype == want[2].dtype == np.float32
    t = T.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(t, torch.Tensor) and t.shape == (2, 2)


# -- workers -------------------------------------------------------------------------

class WhoAmI(T.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = T.get_worker_info()
        cuda_hidden = os.environ.get("CUDA_VISIBLE_DEVICES") == ""
        return np.array([info.id, info.num_workers,
                         torch.get_num_threads(), int(cuda_hidden),
                         int(info.dataset is not None)], np.int64)


def test_workers_see_their_info_one_thread_and_no_card():
    assert T.get_worker_info() is None
    batches = list(T.DataLoader(WhoAmI(), batch_size=2, num_workers=2,
                                places="cpu"))
    ids = [int(b[0][0]) for b in batches]
    assert ids == [0, 1, 0, 1]  # the round-robin merge
    for b in batches:
        assert b[:, 1:].tolist() == [[2, 1, 1, 1]] * 2


class Raises(Rows):
    def __getitem__(self, i):
        if i == 9:
            raise ValueError("sample 9 is broken")
        return super().__getitem__(i)


def test_a_worker_error_surfaces_in_the_parent():
    loader = T.DataLoader(Raises(), batch_size=4, num_workers=2,
                          places="cpu")
    with pytest.raises(RuntimeError, match="sample 9 is broken"):
        list(loader)


class Dies(Rows):
    def __getitem__(self, i):
        if i == 6:
            os.kill(os.getpid(), signal.SIGKILL)
        return super().__getitem__(i)


def test_a_killed_worker_is_found(monkeypatch):
    monkeypatch.setattr(shm_worker, "POLL_MS", 200)
    loader = T.DataLoader(Dies(), batch_size=2, num_workers=2, places="cpu")
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(loader)


def test_a_ring_that_cannot_be_made_raises():
    loader = T.DataLoader(Rows(), batch_size=2, num_workers=2, places="cpu",
                          shm_capacity=1 << 62)
    with pytest.raises(RuntimeError, match="could not create shm ring"):
        iter(loader)


def test_the_ring_counts_what_it_moved():
    loader = T.DataLoader(Rows(), batch_size=5, num_workers=2, places="cpu")
    assert len(list(loader)) == 5
    st = loader.last_stats
    assert st["batches"] == 5 and st["bytes"] > 0
    assert st["wait_ns"] >= 0 and st["read_ns"] > 0


def test_the_loader_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert T.DataLoader(Rows()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.DataLoader(Rows())
    assert T.DataLoader(Rows(), places=["cpu"]).device.type == "cpu"


def test_the_wait_feeds_the_step_timers_counter():
    """With tracing on for ``dataloader`` the consumer's wait on the rings
    is the ``dataloader_wait_ns`` counter that ``StepTimer`` reads."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.observability import tracing
    before = (monitor.stat_get("dataloader_wait_ns"),
              monitor.stat_get("dataloader_batches"))
    tracing.enable(["dataloader"])
    try:
        loader = T.DataLoader(Rows(), batch_size=5, num_workers=2,
                              places="cpu")
        assert len(list(loader)) == 5
    finally:
        tracing.disable()
    assert monitor.stat_get("dataloader_batches") - before[1] == 5
    assert monitor.stat_get("dataloader_wait_ns") - before[0] == \
        loader.last_stats["wait_ns"]
