"""Multi-threaded PS trainer — the DeviceWorker analog (counterpart:
``paddle_tpu/distributed/ps/trainer.py``; the reference framework's
`framework/device_worker.h` HogwildWorker:244 / DownpourWorker:275 driven
by `framework/trainer.h` DistMultiTrainer via exe.train_from_dataset,
call stack CS5 in SURVEY.md).

Design: each worker thread holds its OWN model replica (the reference's
thread scopes) bound to a thread-local communicator over the SHARED
PsClient; sparse lookups pull from the servers, gradients push back
asynchronously (Hogwild-style staleness, exactly the reference's async
mode). Threads pull batches from the fleet Dataset's shared queue. torch
ops release the GIL, so threads genuinely overlap.
"""
import queue
import threading

from .communicator import AsyncCommunicator
from .embedding import flush_sparse_grads, host_array


class DownpourWorker:
    """One training thread (reference: DownpourWorker::TrainFiles)."""

    def __init__(self, thread_id, model, loss_fn, communicator,
                 batch_queue, stats, stats_lock):
        self.thread_id = thread_id
        self.model = model
        self.loss_fn = loss_fn
        self.comm = communicator
        self.queue = batch_queue
        self.stats = stats
        self.lock = stats_lock
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()

    def join(self):
        self.thread.join()

    def _run(self):
        while True:
            batch = self.queue.get()
            try:
                if batch is None:  # poison pill
                    return
                if self.stats.get("error") is not None:
                    continue  # drain without working; trainer will raise
                loss = self.loss_fn(self.model, batch)
                loss.backward()
                flush_sparse_grads(self.comm)
                self.comm.step()
                with self.lock:
                    self.stats["batches"] += 1
                    self.stats["loss_sum"] += float(host_array(loss))
                    self.stats["per_thread"][self.thread_id] += 1
            except Exception as e:  # record + keep draining: a dead
                # thread that stops calling task_done would deadlock
                # train_from_dataset's queue.join()
                with self.lock:
                    if self.stats.get("error") is None:
                        self.stats["error"] = e
            finally:
                self.queue.task_done()


class DownpourTrainer:
    """train_from_dataset over the PS (reference: DistMultiTrainer — one
    DeviceWorker per thread, a shared DataFeed channel, async PS I/O).

    model_builder() must construct a fresh replica whose SparseEmbedding
    layers use EXPLICIT table_ids (replicas must address the same server
    tables). Dense variables train through the PS like the single-thread
    communicators do.
    """

    def __init__(self, runtime, model_builder, loss_fn, n_threads=2,
                 pull_every=1):
        self.runtime = runtime
        self.n_threads = n_threads
        self.stats = {"batches": 0, "loss_sum": 0.0, "error": None,
                      "per_thread": [0] * n_threads}
        self._lock = threading.Lock()
        self._queue = queue.Queue(maxsize=4 * n_threads)
        self.workers = []
        for tid in range(n_threads):
            from . import bind_model
            model = model_builder()
            comm = AsyncCommunicator(runtime.client,
                                     n_workers=runtime.role.worker_num(),
                                     pull_every=pull_every)
            bind_model(model, comm)
            comm.init_params()
            self.workers.append(DownpourWorker(
                tid, model, loss_fn, comm, self._queue, self.stats,
                self._lock))

    @staticmethod
    def _embeddings(model):
        from .embedding import SparseEmbedding
        return [sub for sub in model.sublayers(include_self=True)
                if isinstance(sub, SparseEmbedding)]

    def train_from_dataset(self, batches):
        """Drive the worker threads over an iterable of batches (a fleet
        Dataset's batch iterator or any generator)."""
        for w in self.workers:
            w.start()
        for batch in batches:
            self._queue.put(batch)
        for _ in self.workers:
            self._queue.put(None)
        self._queue.join()
        for w in self.workers:
            w.join()
        for w in self.workers:
            w.comm.stop()
        if self.stats.get("error") is not None:
            raise RuntimeError(
                "a DownpourWorker thread failed") from self.stats["error"]
        return dict(self.stats)
