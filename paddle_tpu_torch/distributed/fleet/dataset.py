"""Fleet Dataset — the file-backed ingestion surface (counterpart:
``paddle_tpu/distributed/fleet/dataset.py``).

Reference framework: `paddle/fluid/framework/data_set.{h,cc}` (Dataset
data_set.h:43 — InMemoryDataset :101 with LoadIntoMemory / LocalShuffle /
GlobalShuffle, QueueDataset) fed by `data_feed.{h,cc}` parsers, consumed
by `Executor.train_from_dataset` (`python/paddle/fluid/executor.py:1802`)
via trainer worker threads.

Design: files parse on the host into numpy arrays, shuffle is a
permutation (local) or a hash repartition across workers (global; the
worker's rank and count are the ``torch.distributed`` group's, else one
worker), and a trainer (``distributed.ps.DownpourTrainer``) drives the
batches. The var-slot/pipe-command plumbing maps to a pluggable line
parser.
"""
import hashlib
import random as _random

import numpy as np

__all__ = ["InMemoryDataset", "QueueDataset"]


def _default_parser(line, slots):
    """Parse one sample line: `val val ... \\t val ...` per slot (the
    data_feed MultiSlot text format, collapsed to dense floats)."""
    parts = line.rstrip("\n").split("\t")
    out = []
    for i, name in enumerate(slots):
        toks = parts[i].split() if i < len(parts) else []
        out.append(np.asarray([float(t) for t in toks], np.float32))
    return out


class InMemoryDataset:
    """reference: data_set.h:101 InMemoryDataset."""

    def __init__(self):
        self._filelist = []
        self._slots = []
        self._parser = None
        self._samples = []  # list of per-slot arrays
        self._batch_size = 1
        self._thread_num = 1
        self._pipe_command = None

    # -- reference config surface ----------------------------------------
    def init(self, batch_size=1, thread_num=1, use_var=None, pipe_command=None,
             fs_name=None, fs_ugi=None, download_cmd=None):
        self._batch_size = batch_size
        self._thread_num = thread_num
        if use_var is not None:
            self._slots = [getattr(v, "name", str(v)) for v in use_var]
        self._pipe_command = pipe_command
        return self

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_use_var(self, var_list):
        self._slots = [getattr(v, "name", str(v)) for v in var_list]

    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, thread_num):
        self._thread_num = thread_num

    def set_parser(self, fn):
        """fn(line, slot_names) -> [np.ndarray per slot]."""
        self._parser = fn

    # -- ingestion --------------------------------------------------------
    def load_into_memory(self):
        """reference: LoadIntoMemory data_set.h:101 — parse every file."""
        parser = self._parser or _default_parser
        self._samples = []
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    if line.strip():
                        self._samples.append(parser(line, self._slots))
        return len(self._samples)

    def local_shuffle(self, seed=None):
        """reference: LocalShuffle — permute this worker's samples."""
        rng = _random.Random(seed)
        rng.shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=None, seed=0):
        """reference: GlobalShuffle — repartition samples across workers by
        content hash, then shuffle locally. Single-controller: the hash
        assigns each sample to exactly one worker's shard deterministically
        (the reference ships them over brpc; here each worker loads the full
        filelist and keeps its shard)."""
        from .base.role_maker import _process_rank_world
        rank, n = _process_rank_world()
        if n > 1:
            kept = []
            for s in self._samples:
                h = hashlib.md5(
                    b"|".join(np.asarray(a).tobytes() for a in s)
                    + str(seed).encode()).digest()
                if int.from_bytes(h[:4], "little") % n == rank:
                    kept.append(s)
            self._samples = kept
        self.local_shuffle(seed=seed + 1)

    def release_memory(self):
        self._samples = []

    def get_memory_data_size(self, fleet=None):
        return len(self._samples)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._samples)

    # -- batch iteration ---------------------------------------------------
    def batches(self, drop_last=False):
        bs = self._batch_size
        n = len(self._samples)
        end = n - (n % bs) if drop_last else n
        for i in range(0, end, bs):
            chunk = self._samples[i:i + bs]
            yield {name: np.stack([s[j] for s in chunk])
                   for j, name in enumerate(self._slots)}


class QueueDataset(InMemoryDataset):
    """reference: QueueDataset — streaming variant: batches() parses files
    on the fly instead of holding samples in memory."""

    def load_into_memory(self):
        raise RuntimeError(
            "QueueDataset streams from files; use it directly with "
            "train_from_dataset (reference raises the same way)")

    def batches(self, drop_last=False):
        parser = self._parser or _default_parser
        buf = []
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    buf.append(parser(line, self._slots))
                    if len(buf) == self._batch_size:
                        yield {name: np.stack([s[j] for s in buf])
                               for j, name in enumerate(self._slots)}
                        buf = []
        if buf and not drop_last:
            yield {name: np.stack([s[j] for s in buf])
                   for j, name in enumerate(self._slots)}
