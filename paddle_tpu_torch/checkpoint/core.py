"""Crash-consistent checkpoint directories (counterpart:
``paddle_tpu/checkpoint/core.py``; the step directories' names, the
manifest's fields and ``LATEST`` are the reference's, so either package
reads what the other wrote).

Every checkpoint is published atomically or not at all:

1. every payload file is written into a hidden staging directory, each
   flushed and fsynced;
2. ``manifest.json`` (the step, user meta and a sha256 per payload file)
   is written last, through its own tmp file and rename inside the staging
   directory, so a manifest's existence implies every payload it names was
   written whole;
3. the staging directory is fsynced and renamed to ``step_<n>/`` (one
   ``rename(2)``: the only instant the checkpoint becomes visible), and the
   parent directory is fsynced;
4. an advisory ``LATEST`` pointer is refreshed and checkpoints beyond
   ``keep_last_n`` are deleted.

Restore accepts only a ``step_*`` directory whose manifest parses and
whose payload hashes verify; anything else (a torn write, a stray staging
directory, a flipped bit) is skipped, counted by
``checkpoint_corrupt_skipped_total``, and the newest valid checkpoint wins.

Every write stage carries a named kill point (``KILL_POINTS``, fired by
``testing.faults``): a writer killed at any of them never leaves a
manifest that restore accepts half-written.
"""
import hashlib
import json
import os
import re
import time

from .. import monitor as _monitor
from ..distributed.fleet.utils.fs import LocalFS
from ..observability import runlog as _runlog
from ..observability import tracing as _obs
from ..testing import faults as _faults

__all__ = ["write_checkpoint", "read_checkpoint", "valid_steps",
           "latest_step", "peek_meta", "gc_checkpoints", "step_dirname",
           "CheckpointError", "CheckpointCorruptError", "KILL_POINTS",
           "MANIFEST_NAME"]

MANIFEST_NAME = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d{10})$")
_STAGING_PREFIX = ".staging."

# every stage of the write path, in order — the chaos sweep arms each one
# and asserts restore never accepts a torn checkpoint. Stages up to and
# including "before_publish" must leave the previous checkpoint as the
# newest valid one; from "after_publish" on, the new checkpoint is
# complete and must be the one restore picks.
KILL_POINTS = (
    "checkpoint/begin",
    "checkpoint/data_partial",
    "checkpoint/data_written",
    "checkpoint/manifest_partial",
    "checkpoint/manifest_written",
    "checkpoint/before_publish",
    "checkpoint/after_publish",
    "checkpoint/before_gc",
)


class CheckpointError(RuntimeError):
    pass


def _local_fs(fs):
    """The core writes payloads with ``open()`` and ``os.fsync`` and
    publishes with ``rename(2)``, POSIX semantics that only a LocalFS
    path (a local disk or a fuse mount) provides: anything else is refused
    before a byte is written."""
    fs = fs or LocalFS()
    if not isinstance(fs, LocalFS):
        raise NotImplementedError(
            f"checkpoint core requires a LocalFS-compatible filesystem "
            f"(got {type(fs).__name__}); mount remote storage (a fuse "
            "mount or NFS) and point the checkpoint root at the mount instead")
    return fs


class CheckpointCorruptError(CheckpointError):
    """An explicitly requested checkpoint failed manifest/hash validation."""


def step_dirname(step):
    return f"step_{int(step):010d}"


def _sha256(data):
    return hashlib.sha256(data).hexdigest()


def write_checkpoint(root, step, payloads, meta=None, fs=None,
                     keep_last_n=None):
    """Atomically publish ``{root}/step_<step>/`` containing ``payloads``
    (a dict ``filename -> bytes``) and a manifest. Returns the published
    directory path. Re-saving an existing step replaces it atomically."""
    if not payloads:
        raise ValueError("write_checkpoint needs at least one payload")
    for name in payloads:
        if name == MANIFEST_NAME or os.sep in name or name.startswith("."):
            raise ValueError(f"invalid payload file name {name!r}")
    fs = _local_fs(fs)
    t0 = _obs.now_ns()
    with _obs.trace_span("checkpoint/save", cat="checkpoint", step=step,
                         files=len(payloads)):
        fs.mkdirs(root)
        _faults.kill_point("checkpoint/begin")
        staging = os.path.join(
            root, f"{_STAGING_PREFIX}{step_dirname(step)}.{os.getpid()}")
        fs.delete(staging)  # a previous crashed attempt for this step
        fs.mkdirs(staging)
        n_bytes = 0
        files = {}
        # per-stage child spans inside the save span: a slow or crashed
        # save decomposes into data-write vs manifest vs publish in the
        # trace (and in a flight-recorder dump, the last stage span names
        # how far the writer got)
        with _obs.trace_span("checkpoint/write_data", cat="checkpoint",
                             files=len(payloads)):
            for name, data in sorted(payloads.items()):
                if not isinstance(data, (bytes, bytearray, memoryview)):
                    raise TypeError(f"payload {name!r} must be bytes, got "
                                    f"{type(data).__name__}")
                data = bytes(data)
                path = os.path.join(staging, name)
                with open(path, "wb") as f:
                    half = len(data) // 2
                    f.write(data[:half])
                    f.flush()
                    # the torn-payload crash: file exists, incomplete
                    _faults.kill_point("checkpoint/data_partial")
                    f.write(data[half:])
                    f.flush()
                    os.fsync(f.fileno())
                files[name] = {"sha256": _sha256(data), "bytes": len(data)}
                n_bytes += len(data)
            _faults.kill_point("checkpoint/data_written")

        manifest = {"format": 1, "step": int(step), "time": time.time(),
                    "meta": meta or {}, "files": files}
        text = json.dumps(manifest, indent=1, sort_keys=True)
        with _obs.trace_span("checkpoint/write_manifest",
                             cat="checkpoint"):
            mtmp = os.path.join(staging, MANIFEST_NAME + ".tmp")
            with open(mtmp, "w") as f:
                f.write(text[:len(text) // 2])
                f.flush()
                # the torn-manifest crash: only the .tmp name ever holds
                # a partial manifest, so restore can never parse half
                _faults.kill_point("checkpoint/manifest_partial")
                f.write(text[len(text) // 2:])
                f.flush()
                os.fsync(f.fileno())
            fs.rename(mtmp, os.path.join(staging, MANIFEST_NAME))
            fs.fsync(staging)
            _faults.kill_point("checkpoint/manifest_written")

        with _obs.trace_span("checkpoint/publish", cat="checkpoint",
                             step=step):
            _faults.kill_point("checkpoint/before_publish")
            final = os.path.join(root, step_dirname(step))
            fs.delete(final)  # replace a same-step checkpoint atomically
            fs.rename(staging, final)  # THE publish instant
            fs.fsync(root)
            _faults.kill_point("checkpoint/after_publish")

        _write_latest(root, step, fs)
        _runlog.event("checkpoint_publish", step=int(step),
                      bytes=n_bytes, files=len(files), path=final)
        _faults.kill_point("checkpoint/before_gc")
        if keep_last_n is not None:
            gc_checkpoints(root, keep_last_n, fs=fs)
    _monitor.stat_add("checkpoint_saves_total", 1)
    _monitor.stat_add("checkpoint_bytes_written_total", n_bytes)
    _monitor.stat_add("checkpoint_save_ns", _obs.now_ns() - t0)
    return final


def _write_latest(root, step, fs):
    """Advisory newest-step pointer (restore re-derives the truth from the
    manifests; a torn LATEST is ignored)."""
    tmp = os.path.join(root, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(step_dirname(step) + "\n")
        f.flush()
        os.fsync(f.fileno())
    fs.rename(tmp, os.path.join(root, "LATEST"))


def _read_manifest(root, step):
    path = os.path.join(root, step_dirname(step), MANIFEST_NAME)
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or m.get("format") != 1 \
            or not isinstance(m.get("files"), dict):
        return None
    return m


def valid_steps(root, fs=None):
    """Sorted step numbers under ``root`` whose manifest parses. (Payload
    hashes are verified at read time — parsing here keeps listing cheap.)"""
    fs = _local_fs(fs)
    steps = []
    for name in fs.ls_dir(root)[0]:
        m = _STEP_RE.match(name)
        if m and _read_manifest(root, int(m.group(1))) is not None:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(root, fs=None):
    steps = valid_steps(root, fs=fs)
    return steps[-1] if steps else None


def _verify_and_load(root, step, manifest):
    """Hash-check every payload named by the manifest; returns the loaded
    ``{name: bytes}`` or None when anything is missing/corrupt."""
    d = os.path.join(root, step_dirname(step))
    out = {}
    for name, rec in manifest["files"].items():
        path = os.path.join(d, name)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if len(data) != rec.get("bytes") or _sha256(data) != rec.get("sha256"):
            return None
        out[name] = data
    return out


def read_checkpoint(root, step=None, fs=None):
    """Load a checkpoint: ``(step, payloads, meta)``.

    ``step=None`` picks the newest checkpoint that fully validates
    (manifest parses AND every payload hash matches), silently skipping
    corrupt ones — each skip bumps ``checkpoint_corrupt_skipped_total``.
    An explicit ``step`` that exists but fails validation raises
    :class:`CheckpointCorruptError` instead (the caller asked for THAT
    state; handing back an older one would be silent data loss). Returns
    ``None`` when no valid checkpoint exists."""
    fs = _local_fs(fs)
    t0 = _obs.now_ns()
    with _obs.trace_span("checkpoint/restore", cat="checkpoint",
                         step=-1 if step is None else step):
        if step is not None:
            manifest = _read_manifest(root, step)
            if manifest is None:
                if fs.is_dir(os.path.join(root, step_dirname(step))):
                    raise CheckpointCorruptError(
                        f"checkpoint step {step} at {root!r} has a "
                        "missing/torn manifest")
                return None
            payloads = _verify_and_load(root, step, manifest)
            if payloads is None:
                raise CheckpointCorruptError(
                    f"checkpoint step {step} at {root!r} failed content-"
                    "hash validation (torn or bit-flipped payload)")
            chosen = (step, payloads, manifest)
        else:
            chosen = None
            for s in reversed(valid_steps(root, fs=fs)):
                # re-read: the dir may have been GC'd by a concurrent
                # writer between the listing and now — skip, don't crash
                manifest = _read_manifest(root, s)
                payloads = (None if manifest is None
                            else _verify_and_load(root, s, manifest))
                if payloads is not None:
                    chosen = (s, payloads, manifest)
                    break
                _monitor.stat_add("checkpoint_corrupt_skipped_total", 1)
            if chosen is None:
                return None
    _monitor.stat_add("checkpoint_restores_total", 1)
    _monitor.stat_add("checkpoint_restore_ns", _obs.now_ns() - t0)
    _runlog.event("checkpoint_restore", step=chosen[0],
                  bytes=sum(len(v) for v in chosen[1].values()))
    return chosen[0], chosen[1], chosen[2].get("meta", {})


def _staging_stale(name):
    """Is a staging dir provably abandoned? The dirname carries its
    writer's pid; only sweep when that pid is THIS process (our own
    crashed earlier attempt) or no longer alive — a live concurrent
    writer's staging dir must survive or its publish rename fails."""
    try:
        pid = int(name.rsplit(".", 1)[1])
    except (IndexError, ValueError):
        return True  # not ours / malformed: treat as debris
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except OSError:
        pass  # alive but not ours (EPERM): leave it
    return False


def peek_meta(root, fs=None):
    """``(step, meta)`` of the newest checkpoint whose MANIFEST parses,
    without reading or hash-verifying any payload — the cheap job-startup
    peek ("which epoch do I resume from?"). The authoritative answer is
    the meta :func:`read_checkpoint` returns at actual restore time: a
    checkpoint whose payloads turn out corrupt is skipped there, so a
    caller resuming a loop should trust the restore's meta over the
    peek's. Returns ``None`` when no manifest parses."""
    fs = _local_fs(fs)
    for s in reversed(valid_steps(root, fs=fs)):
        manifest = _read_manifest(root, s)  # may vanish under racing GC
        if manifest is not None:
            return s, manifest.get("meta", {})
    return None


def gc_checkpoints(root, keep_last_n, fs=None):
    """Delete all but the newest ``keep_last_n`` valid checkpoints, plus
    any abandoned staging directories (dead writer pid) and invalid step
    dirs older than the newest valid one. Returns the number of
    directories removed."""
    if keep_last_n is not None and int(keep_last_n) < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    fs = _local_fs(fs)
    steps = valid_steps(root, fs=fs)
    # keep_last_n=None keeps every valid checkpoint: the call still
    # sweeps abandoned staging dirs and invalid step dirs
    keep = set(steps if keep_last_n is None
               else steps[-int(keep_last_n):])
    removed = 0
    newest = steps[-1] if steps else None
    for name in fs.ls_dir(root)[0]:
        if name.startswith(_STAGING_PREFIX):
            if _staging_stale(name):
                fs.delete(os.path.join(root, name))
                removed += 1
            continue
        m = _STEP_RE.match(name)
        if not m:
            continue
        s = int(m.group(1))
        if s in keep:
            continue
        # invalid dirs NEWER than the newest valid checkpoint are left
        # alone: they may be another writer's publish racing this GC
        if s in steps or (newest is not None and s < newest):
            fs.delete(os.path.join(root, name))
            removed += 1
    if removed:
        _monitor.stat_add("checkpoint_gc_removed_total", removed)
    return removed
