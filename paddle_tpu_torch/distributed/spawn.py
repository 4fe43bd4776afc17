"""``spawn`` (counterpart: ``paddle_tpu/distributed/spawn.py``; the
reference's ``python/paddle/distributed/spawn.py:333``).

Real N-process spawn on one host. Each child takes the launcher's
environment contract (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``; the first
endpoint, ``MASTER_ADDR``/``MASTER_PORT``, is the ``torch.distributed``
rendezvous where the reference starts jax's coordination service) and
brings up the default process group (``init_parallel_env``: gloo with
``backend="cpu"``, NCCL on the card) before calling ``func``. With the
default ``nprocs=-1`` (or 1) ``func`` runs in this process.

Every child runs with ``TORCH_SHOW_CPP_STACKTRACES=1`` and writes its
stderr to a file of its own, so a rank that dies (a signal, a native
abort with no Python traceback) is reported with its signal or exit code
and the tail of its stderr.
"""
import multiprocessing
import os
import tempfile
import time
import traceback

from .parallel_env import _free_port

__all__ = ["spawn"]

_STDERR_TAIL = 4000  # bytes of a dead rank's stderr in the report


def _spawn_target(func, args, rank, nprocs, port, options, queue,
                  stderr_path):
    # this rank's stderr (a native abort's message included) to its file
    fd = os.open(stderr_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        endpoints = [f"127.0.0.1:{port + i}" for i in range(nprocs)]
        os.environ["PADDLE_TRAINER_ID"] = str(rank)
        os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
        os.environ["PADDLE_TRAINER_ENDPOINTS"] = ",".join(endpoints)
        os.environ["PADDLE_CURRENT_ENDPOINT"] = endpoints[rank]
        os.environ["MASTER_ADDR"] = "127.0.0.1"
        os.environ["MASTER_PORT"] = str(port)
        from . import parallel_env
        parallel_env.init_parallel_env(
            device="cpu" if options.get("backend") == "cpu" else None)
        result = func(*args)
        queue.put((rank, "ok", result))
    except Exception:
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes running ``func(*args)`` (``func``
    picklable, module-level). ``options``: ``backend="cpu"`` for gloo
    ranks on the host (the default is the card, NCCL), ``timeout``
    (seconds, default 300). Returns the context (``.results``: ``[(rank,
    "ok", result)]`` once joined)."""
    if nprocs in (-1, 1):
        result = func(*args)
        return _Context([(0, "ok", result)])

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    log_dir = tempfile.mkdtemp(prefix="spawn_")
    procs, paths = [], []
    saved = os.environ.get("TORCH_SHOW_CPP_STACKTRACES")
    os.environ["TORCH_SHOW_CPP_STACKTRACES"] = "1"  # inherited by children
    try:
        for rank in range(nprocs):
            path = os.path.join(log_dir, f"rank{rank}.stderr")
            p = ctx.Process(target=_spawn_target,
                            args=(func, args, rank, nprocs, port, options,
                                  queue, path),
                            daemon=daemon)
            p.start()
            procs.append(p)
            paths.append(path)
    finally:
        if saved is None:
            os.environ.pop("TORCH_SHOW_CPP_STACKTRACES", None)
        else:
            os.environ["TORCH_SHOW_CPP_STACKTRACES"] = saved
    context = _Context(None, procs=procs, queue=queue,
                       timeout=options.get("timeout", 300),
                       stderr_paths=paths)
    if join:
        context.join()
    return context


def _tail(path, n=_STDERR_TAIL):
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(f.tell() - n, 0))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class _Context:
    def __init__(self, results, procs=None, queue=None, timeout=300,
                 stderr_paths=()):
        self.results = results
        self._procs = procs or []
        self._queue = queue
        self._timeout = timeout
        self.stderr_paths = list(stderr_paths)

    @staticmethod
    def _signal_name(exitcode):
        from .launch import signal_name
        return signal_name(exitcode)

    def _stderr(self, rank):
        if rank >= len(self.stderr_paths):
            return ""
        text = _tail(self.stderr_paths[rank]).strip()
        return f"\n  stderr tail of rank {rank}:\n{text}" if text else ""

    def join(self):
        import queue as _queue_mod

        if self.results is not None:
            return True
        out = {}
        died = None
        signal_deaths = {}
        deadline = time.time() + self._timeout
        try:
            while len(out) + len(signal_deaths) < len(self._procs):
                try:
                    rank, status, payload = self._queue.get(timeout=0.2)
                    out[rank] = (rank, status, payload)
                    continue
                except _queue_mod.Empty:
                    pass
                # a child killed by a signal never posts a result: reap it
                # now, or the join blocks its whole timeout while the peers
                # wait on the dead rank's collectives
                for i, p in enumerate(self._procs):
                    if i in out or i in signal_deaths:
                        continue
                    ec = p.exitcode
                    if ec is not None and ec < 0:
                        signal_deaths[i] = self._signal_name(ec)
                if signal_deaths:
                    break
                if time.time() > deadline:
                    died = [(i, ("alive/hung" if p.is_alive()
                                 else f"exit {p.exitcode}"))
                            for i, p in enumerate(self._procs)]
                    break
            if signal_deaths:
                while True:
                    try:
                        rank, status, payload = self._queue.get_nowait()
                        out[rank] = (rank, status, payload)
                    except _queue_mod.Empty:
                        break
        finally:
            join_s = 2.0 if signal_deaths else self._timeout
            for p in self._procs:
                p.join(join_s)
                if p.is_alive():
                    p.terminate()
        errors = [f"rank {r} failed:\n{payload}{self._stderr(r)}"
                  for r, (_, status, payload) in sorted(out.items())
                  if status == "error"]
        for i, sig in sorted(signal_deaths.items()):
            errors.append(
                f"rank {i} died by {sig} without reporting a result (an "
                "external kill or a native crash); surviving ranks were "
                f"terminated{self._stderr(i)}")
        if died is not None:
            missing = sorted(set(range(len(self._procs))) - set(out))
            states = dict(died)
            for i in missing:
                errors.append(
                    f"rank {i} did not report within {self._timeout}s "
                    f"({states.get(i, 'unknown')}: 'alive/hung' is a "
                    "deadlock or a slow step, terminated; an exit code is "
                    f"a native crash or a kill){self._stderr(i)}")
        if errors:
            raise RuntimeError("spawn failed:\n" + "\n".join(errors))
        self.results = [out[r] for r in sorted(out)]
        return True
