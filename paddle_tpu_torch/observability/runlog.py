"""Structured run-log: one append-only JSONL event stream per process
(counterpart: ``paddle_tpu/observability/runlog.py``).

Each file starts with a ``manifest`` record (run id, rank, pid, wall and
monotonic clock anchors, git sha, user meta) and then holds one JSON object
a line:

- ``span``: completed spans with their (trace, span, parent) ids, from the
  tracing layer whenever a run-log is active;
- ``event``: discrete facts, such as checkpoint publishes and restores and
  fired fault injections.

Activation: ``start_run(dir)``, or ``PADDLE_TPU_RUNLOG_DIR`` and
``observability.enable()``. Files are named
``<run_id>.rank<r>.pid<pid>.jsonl``, so concurrent writers never share a
file; past ``max_bytes`` a file rolls to ``<base>.partN.jsonl``, which
opens with a continuation manifest.
"""
import json
import os
import threading
import time


__all__ = ["RunLog", "start_run", "stop_run", "active", "event", "span",
           "log_path"]

_lock = threading.Lock()
_active = [None]


def _now_ns():
    return time.monotonic_ns()  # the tracing layer's span clock


def _git_sha(repo_root):
    """Best-effort HEAD sha without subprocess (no git binary needed)."""
    try:
        git = os.path.join(repo_root, ".git")
        with open(os.path.join(git, "HEAD")) as f:
            head = f.read().strip()
        if head.startswith("ref:"):
            ref = head.split(None, 1)[1]
            ref_path = os.path.join(git, *ref.split("/"))
            if os.path.exists(ref_path):
                with open(ref_path) as f:
                    return f.read().strip()
            with open(os.path.join(git, "packed-refs")) as f:
                for line in f:
                    if line.strip().endswith(ref):
                        return line.split()[0]
            return None
        return head
    except OSError:
        return None


class RunLog:
    """One process's append-only JSONL event stream.

    Thread-safe: every record is serialized under a lock and written as
    one line + flush, so a crash loses at most the line being written
    and concurrent worker threads never interleave bytes.

    ``max_bytes`` bounds each file: when a write crosses the limit the
    log ROLLS to ``<base>.partN.jsonl`` — the new part opens with a
    continuation manifest (same run/rank/pid identity plus ``part`` and
    ``continues``), so a long run cannot fill the disk with one file.
    """

    def __init__(self, path, run_id=None, rank=None, meta=None,
                 process=None, max_bytes=None):
        self.base_path = path
        self.path = path
        self.paths = [path]
        self.run_id = run_id
        self.rank = rank
        self.process = process or "main"
        self.max_bytes = (None if not max_bytes
                          else max(4096, int(max_bytes)))
        self.part = 0
        self._f = open(path, "a")
        # append mode may land on an existing file (same pid re-running
        # start_run, or an explicit path=): count what's already there
        # or max_bytes would bound only the NEW bytes, not the file
        self._bytes = self._f.tell()
        self._lock = threading.Lock()
        self.events_written = 0
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self._git_sha = _git_sha(repo_root)
        self._meta = meta or {}
        # wall + monotonic anchors: a reader aligns files of processes
        # (or hosts) with different clock bases from the pair
        self._write(self._manifest())

    def _manifest(self, continues=None):
        rec = {
            "kind": "manifest", "run_id": self.run_id, "rank": self.rank,
            "pid": os.getpid(), "process": self.process,
            "time": time.time(), "mono_ns": _now_ns(),
            "git_sha": self._git_sha,
            "meta": self._meta,
        }
        if self.part:
            rec["part"] = self.part
        if continues:
            rec["continues"] = continues
        return rec

    def _part_path(self, n):
        base = self.base_path
        if base.endswith(".jsonl"):
            return f"{base[:-len('.jsonl')]}.part{n}.jsonl"
        return f"{base}.part{n}"

    def _write_line(self, line):
        self._f.write(line + "\n")
        self._bytes += len(line) + 1
        self.events_written += 1

    def _write(self, rec):
        line = json.dumps(rec, default=str)
        with self._lock:
            if self._f is None:
                return
            self._write_line(line)
            if self.max_bytes is not None and self._bytes >= self.max_bytes:
                # roll INSIDE the lock: close the full part, open the
                # next one, and lead it with a continuation manifest
                # (fresh clock anchors; same process identity)
                prev = self.path
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()
                self.part += 1
                self.path = self._part_path(self.part)
                self.paths.append(self.path)
                self._f = open(self.path, "a")
                self._bytes = self._f.tell()
                self._write_line(json.dumps(
                    self._manifest(continues=os.path.basename(prev)),
                    default=str))
            self._f.flush()

    def span(self, name, cat, t0, t1, trace_id, span_id, parent_id,
             attrs=None, process=None, tid=None):
        rec = {"kind": "span", "name": name, "cat": cat,
               "t0": int(t0), "dur": int(t1) - int(t0),
               "trace": f"{trace_id:016x}", "span": f"{span_id:016x}",
               "tid": (threading.get_ident() % (1 << 31)
                       if tid is None else int(tid))}
        if parent_id:
            rec["parent"] = f"{parent_id:016x}"
        if attrs:
            rec["attrs"] = {k: (v if isinstance(v, (int, float, str, bool,
                                                    list)) else str(v))
                            for k, v in attrs.items()}
        if process:
            rec["process"] = process
        self._write(rec)

    def event(self, what, **fields):
        rec = {"kind": "event", "event": what, "t": _now_ns()}
        rec.update(fields)
        self._write(rec)

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()
                self._f = None


def _env_max_bytes():
    """``PADDLE_TPU_RUNLOG_MAX_MB`` -> bytes (None when unset/invalid)."""
    raw = os.environ.get("PADDLE_TPU_RUNLOG_MAX_MB")
    if not raw:
        return None
    try:
        mb = float(raw)
    except ValueError:
        return None
    return int(mb * 1024 * 1024) if mb > 0 else None


def start_run(dir=None, path=None, run_id=None, rank=None, meta=None,
              process=None, max_bytes=None):
    """Open the process-wide run-log (replacing any active one). Either
    ``dir`` (file name derived: ``<run_id>.rank<r>.pid<pid>.jsonl``) or
    an explicit ``path``. ``rank`` defaults to ``PADDLE_TRAINER_ID``.
    ``max_bytes`` (or ``PADDLE_TPU_RUNLOG_MAX_MB``) bounds each file:
    past the limit the log rolls to ``<base>.partN.jsonl`` with a
    continuation manifest — see :class:`RunLog`."""
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if run_id is None:
        run_id = os.environ.get("PADDLE_TPU_RUN_ID", "run")
    if max_bytes is None:
        max_bytes = _env_max_bytes()
    if path is None:
        if dir is None:
            raise ValueError("start_run needs dir= or path=")
        os.makedirs(dir, exist_ok=True)
        path = os.path.join(
            dir, f"{run_id}.rank{rank}.pid{os.getpid()}.jsonl")
    log = RunLog(path, run_id=run_id, rank=rank, meta=meta,
                 process=process, max_bytes=max_bytes)
    with _lock:
        old, _active[0] = _active[0], log
    if old is not None:
        old.close()
    return log


def stop_run():
    """Close the active run-log (no-op when none is active)."""
    with _lock:
        log, _active[0] = _active[0], None
    if log is not None:
        log.close()


def maybe_start_from_env():
    """Auto-start from ``PADDLE_TPU_RUNLOG_DIR`` (idempotent): the
    multi-process activation path — the launcher exports one env var and
    every rank logs to its own file."""
    d = os.environ.get("PADDLE_TPU_RUNLOG_DIR")
    if d and _active[0] is None:
        start_run(dir=d)


def active():
    """The active :class:`RunLog`, or None."""
    return _active[0]


def log_path():
    log = _active[0]
    return None if log is None else log.path


def span(*args, **kwargs):
    """Record a span into the active run-log (tracing's emission hook);
    no-op when inactive."""
    log = _active[0]
    if log is not None:
        log.span(*args, **kwargs)


def event(what, **fields):
    """Record a discrete event (step stats, checkpoint publish, retry,
    shed, fault fire) into the active run-log; no-op when inactive."""
    log = _active[0]
    if log is not None:
        log.event(what, **fields)
