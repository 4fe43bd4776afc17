"""Multi-process checkpoints: per-rank shard files under a rank-0
manifest (counterpart: ``paddle_tpu/checkpoint/multihost.py``).

The single-process core (``checkpoint.core``) publishes a directory from
one writer; a pod checkpoint has one writer a rank on a shared filesystem.
:func:`write_pod_checkpoint`:

1. every rank writes its own payload files (prefixed ``rank<r>__``) into
   a shared staging directory, each flushed and fsynced, then atomically
   drops a ``.ready.rank<r>.json`` marker holding its files' hashes;
2. the committer, rank 0 of the world, waits for every marker (a rank
   that dies mid-save fails the checkpoint at the timeout instead of
   hanging it), then writes one ``manifest.json`` covering every rank's
   files and publishes with the core's single ``rename(2)``;
3. the other ranks wait until the published manifest covers their files.

A kill at any stage (kill points ``checkpoint/pod_shard_partial``,
``checkpoint/pod_shard_written``, ``checkpoint/pod_before_commit``,
``checkpoint/pod_after_commit``) never leaves a manifest that names a
half-written file, so ``core.read_checkpoint`` restores the previous
checkpoint or the complete new one.

Each rank's optimizer payload holds only its rows of every ZeRO store (the
port's ranks hold exactly those: :func:`partition_optimizer`) and its
round-robin share of the other entries (:func:`partition_model`).
:class:`PodCheckpointManager` ``restore()`` merges every rank's files into
one record whose store slots hold a list of shards, which
``state.restore_optimizer`` re-flattens for the live layout: a checkpoint
taken at world W restores at any other world, in either package.
"""
import json
import os
import re
import time

import numpy as np

from .. import monitor as _monitor
from ..distributed import parallel_env
from ..observability import runlog as _runlog
from ..observability import tracing as _obs
from ..testing import faults as _faults
from . import core, state

__all__ = ["write_pod_checkpoint", "read_pod_checkpoint",
           "partition_model", "merge_model", "partition_optimizer",
           "merge_optimizer", "PodCheckpointManager",
           "PodCheckpointError", "POD_KILL_POINTS", "shard_payload_name",
           "split_pod_payloads"]

_POD_STAGING_PREFIX = ".podstaging."
_SHARD_RE = re.compile(r"^rank(\d+)__(.+)$")
_READY_RE = re.compile(r"^\.ready\.rank(\d+)\.json$")

POD_KILL_POINTS = (
    "checkpoint/pod_shard_partial",
    "checkpoint/pod_shard_written",
    "checkpoint/pod_before_commit",
    "checkpoint/pod_after_commit",
)
# read-side point (not part of the write-stage sweep): a rank killed
# mid-RESTORE — e.g. a replacement dying during its own elastic restore
# after a reform-up — leaves the published checkpoint untouched
POD_RESTORE_KILL_POINT = "checkpoint/pod_restore"


class PodCheckpointError(core.CheckpointError):
    """A pod checkpoint could not complete (dead rank mid-save, commit
    timeout). The in-flight staging directory is left behind —
    harmless: restore only ever reads published manifests, and the
    next publish GC sweeps it."""


def shard_payload_name(rank, name):
    return f"rank{int(rank)}__{name}"


def split_pod_payloads(payloads):
    """``{rank: {name: bytes}}`` from a flat published payload dict."""
    out = {}
    for full, data in payloads.items():
        m = _SHARD_RE.match(full)
        if m:
            out.setdefault(int(m.group(1)), {})[m.group(2)] = data
    return out


# -- write protocol ---------------------------------------------------------

def _staging_dir(root, step, generation):
    """Per-(step, generation) staging: a re-save after an elastic
    re-formation must NOT share a directory with the crashed attempt —
    the old world's ready markers reference payload bytes the new
    (differently-partitioned) world overwrites, and a committer racing
    a marker rewrite could commit stale hashes."""
    return os.path.join(
        root, f"{_POD_STAGING_PREFIX}{core.step_dirname(step)}"
              f".g{int(generation)}")


def _write_shard_file(path, data):
    data = bytes(data)
    with open(path, "wb") as f:
        half = len(data) // 2
        f.write(data[:half])
        f.flush()
        _faults.kill_point("checkpoint/pod_shard_partial")
        f.write(data[half:])
        f.flush()
        os.fsync(f.fileno())
    return {"sha256": core._sha256(data), "bytes": len(data)}


def _manifest_covers(root, step, files):
    """Does the PUBLISHED manifest for ``step`` name every file in
    ``files`` with matching hashes? (The non-committer's publish
    evidence: its own shards, with this attempt's content, are durably
    committed.)"""
    manifest = core._read_manifest(root, step)
    if manifest is None:
        return False
    published = manifest.get("files") or {}
    return all(published.get(name) == rec for name, rec in files.items())


def _poll(what, deadline, pod, poll_s=0.05):
    """One failure-aware wait tick; raises on dead rank or deadline."""
    if pod is not None:
        pod.check_failures()  # dead rank mid-save -> RankFailedError
    if time.time() > deadline:
        raise PodCheckpointError(what)
    time.sleep(poll_s)


def write_pod_checkpoint(root, step, payloads, *, rank, world_ranks,
                         pod=None, meta=None, fs=None, keep_last_n=None,
                         timeout=120.0, generation=None):
    """Write this RANK's ``payloads`` (``{filename: bytes}``, prefixed
    ``rank<r>__`` on disk) into the shared pod checkpoint for ``step``;
    the committer (``world_ranks[0]``) publishes the manifest covering
    every rank. Every rank returns the published directory. ``pod`` (an
    object with ``check_failures()``) makes the waits failure-aware;
    without it only ``timeout`` bounds them."""
    if not payloads:
        raise ValueError("write_pod_checkpoint needs at least one payload")
    for name in payloads:
        if name == core.MANIFEST_NAME or os.sep in name \
                or name.startswith("."):
            raise ValueError(f"invalid payload file name {name!r}")
    fs = core._local_fs(fs)
    world_ranks = sorted(int(r) for r in world_ranks)
    rank = int(rank)
    if rank not in world_ranks:
        raise ValueError(f"rank {rank} not in world {world_ranks}")
    if generation is None:
        generation = getattr(pod, "gen", 0) if pod is not None else 0
    committer = world_ranks[0]
    deadline = time.time() + float(timeout)
    final = os.path.join(root, core.step_dirname(step))
    t0 = _obs.now_ns()
    with _obs.trace_span("checkpoint/pod_save", cat="checkpoint",
                         step=step, rank=rank, world=len(world_ranks)):
        fs.mkdirs(root)
        staging = _staging_dir(root, step, generation)
        fs.mkdirs(staging)  # every rank; exist_ok semantics

        files = {}
        n_bytes = 0
        with _obs.trace_span("checkpoint/pod_write_shards",
                             cat="checkpoint", files=len(payloads)):
            for name, data in sorted(payloads.items()):
                if not isinstance(data, (bytes, bytearray, memoryview)):
                    raise TypeError(f"payload {name!r} must be bytes, got "
                                    f"{type(data).__name__}")
                full = shard_payload_name(rank, name)
                files[full] = _write_shard_file(
                    os.path.join(staging, full), data)
                n_bytes += files[full]["bytes"]
        _faults.kill_point("checkpoint/pod_shard_written")

        # atomic ready marker: its existence implies every file it names
        # was fully written + fsynced
        marker = os.path.join(staging, f".ready.rank{rank}.json")
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": rank, "files": files,
                       "world": world_ranks, "time": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        fs.rename(tmp, marker)

        if rank != committer:
            # wait for the committer's publish (failure-aware). Mere
            # manifest EXISTENCE is not publish evidence — a previous
            # same-step checkpoint may already sit at `final` — the
            # published manifest must cover THIS rank's shard files
            # with THIS attempt's hashes
            while not _manifest_covers(root, step, files):
                _poll(f"pod checkpoint step {step}: publish by rank "
                      f"{committer} covering this rank's shards not "
                      f"observed within {timeout:.0f}s",
                      deadline, pod)
            _monitor_stats(n_bytes, t0)
            return final

        # -- committer: collect every rank's marker, then commit --------
        all_files = {}
        waiting = set(world_ranks)
        while waiting:
            for r in sorted(waiting):
                m = os.path.join(staging, f".ready.rank{r}.json")
                try:
                    with open(m) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    continue
                all_files.update(rec.get("files") or {})
                waiting.discard(r)
            if waiting:
                _poll(f"pod checkpoint step {step}: rank(s) "
                      f"{sorted(waiting)} never wrote their shard "
                      f"marker within {timeout:.0f}s",
                      deadline, pod)
        _faults.kill_point("checkpoint/pod_before_commit")

        manifest = {"format": 1, "step": int(step), "time": time.time(),
                    "meta": dict(meta or {}), "files": all_files}
        manifest["meta"].setdefault("pod", {})
        manifest["meta"]["pod"].setdefault("world_ranks", world_ranks)
        text = json.dumps(manifest, indent=1, sort_keys=True)
        with _obs.trace_span("checkpoint/pod_commit", cat="checkpoint",
                             step=step):
            mtmp = os.path.join(staging, core.MANIFEST_NAME + ".tmp")
            with open(mtmp, "w") as f:
                f.write(text)
                f.flush()
                os.fsync(f.fileno())
            fs.rename(mtmp, os.path.join(staging, core.MANIFEST_NAME))
            fs.fsync(staging)
            fs.delete(final)  # replace a same-step checkpoint atomically
            fs.rename(staging, final)  # THE publish instant
            fs.fsync(root)
            _faults.kill_point("checkpoint/pod_after_commit")
        core._write_latest(root, step, fs)
        _runlog.event("checkpoint_publish", step=int(step),
                      bytes=sum(f["bytes"] for f in all_files.values()),
                      files=len(all_files), path=final,
                      pod_world=len(world_ranks))
        if keep_last_n is not None:
            core.gc_checkpoints(root, keep_last_n, fs=fs)
        gc_pod_staging(root, fs=fs)
    _monitor_stats(n_bytes, t0)
    return final


def _monitor_stats(n_bytes, t0):
    _monitor.stat_add("checkpoint_saves_total", 1)
    _monitor.stat_add("checkpoint_bytes_written_total", n_bytes)
    _monitor.stat_add("checkpoint_save_ns", _obs.now_ns() - t0)


def gc_pod_staging(root, fs=None):
    """Sweep abandoned pod staging dirs: any ``.podstaging.step_<n>``
    whose step is <= the newest PUBLISHED step is debris from a crashed
    or superseded save (a publish for that step either happened from a
    different staging generation or rolled past it)."""
    fs = core._local_fs(fs)
    newest = core.latest_step(root, fs=fs)
    if newest is None:
        return 0
    removed = 0
    for name in fs.ls_dir(root)[0]:
        if not name.startswith(_POD_STAGING_PREFIX):
            continue
        m = re.match(r"^step_(\d{10})(?:\.g\d+)?$",
                     name[len(_POD_STAGING_PREFIX):])
        if m and int(m.group(1)) <= newest:
            fs.delete(os.path.join(root, name))
            removed += 1
    return removed


def read_pod_checkpoint(root, step=None, fs=None):
    """Load a pod checkpoint: ``(step, {rank: {name: bytes}}, meta)``
    (validation identical to :func:`core.read_checkpoint` — the manifest
    covers every rank's files). Returns None when nothing valid
    exists."""
    found = core.read_checkpoint(root, step=step, fs=fs)
    if found is None:
        return None
    got_step, payloads, meta = found
    return got_step, split_pod_payloads(payloads), meta


# -- record partitioning (the per-rank shard content) -----------------------

def _entry_owner(names, world):
    """Deterministic entry -> rank assignment: sorted order, round-robin."""
    return {name: i % world for i, name in enumerate(sorted(names))}


def _row_slice(total_rows, rank, world):
    base, rem = divmod(int(total_rows), int(world))
    lo = rank * base + min(rank, rem)
    return lo, lo + base + (1 if rank < rem else 0)


def partition_model(rec, rank, world):
    """This rank's entry-subset of a :func:`state.capture_model` record
    (round-robin over sorted names — the pod analog of saving only the
    host's addressable shards). Rank 0 additionally carries the full
    name list (merge validates coverage) and the ZeRO-3 param names."""
    owner = _entry_owner(rec["state"], world)
    out = {"state": {n: v for n, v in rec["state"].items()
                     if owner[n] == rank},
           "zero3_params": rec.get("zero3_params", []) if rank == 0 else [],
           "pod": {"rank": int(rank), "world": int(world),
                   "names": sorted(rec["state"]) if rank == 0 else None}}
    return out


def merge_model(parts):
    """Union the per-rank model records back into one
    :func:`state.restore_model`-shaped record; raises
    :class:`state.StateMismatchError` when entries are missing (a rank
    file absent from the checkpoint)."""
    merged = {}
    names = None
    zero3 = []
    for rec in parts:
        merged.update(rec.get("state") or {})
        pod = rec.get("pod") or {}
        if pod.get("names") is not None:
            names = pod["names"]
        if rec.get("zero3_params"):
            zero3 = rec["zero3_params"]
    if names is not None:
        missing = sorted(set(names) - set(merged))
        if missing:
            raise state.StateMismatchError(
                f"pod checkpoint is missing model entries {missing} — "
                "a rank shard file is absent from the manifest")
    return {"state": merged, "zero3_params": zero3}


def partition_optimizer(rec, rank, world):
    """This rank's shard of a :func:`state.capture_optimizer` record.

    - scalars (step count, lr, scheduler), surviving grads, and the
      scaler-adjacent bits stay on rank 0 (replicated state, one copy);
    - dense accumulators are entry-sharded (round-robin, like the
      model);
    - flat fused stores and every ZeRO bucket slot are ROW-SLICED:
      rank r keeps the contiguous row block ``_row_slice(rows, r, w)``
      of the (concatenated) store — merge rebuilds a shards LIST that
      drives ``state._restore_store``'s re-flattening. A slot captured
      with ``local=True`` already is this rank's block (its first row
      ``lo``), as a port rank holds it.
    """
    rank, world = int(rank), int(world)
    out = {"pod": {"rank": rank, "world": world}}
    if rank == 0:
        for key in ("step_count", "lr", "lr_scheduler", "grads",
                    "full_layout"):
            if key in rec:
                out[key] = rec[key]

    accs = rec.get("accumulators")
    if accs is not None:
        owner = _entry_owner(accs, world)
        out["accumulators"] = {k: v for k, v in accs.items()
                               if owner[k] == rank}
        if rank == 0:
            out["pod"]["accumulator_names"] = sorted(accs)

    stores = rec.get("flat_stores")
    if stores is not None:
        slices = {}
        for slot, arr in stores.items():
            lo, hi = _row_slice(arr.shape[0], rank, world)
            slices[slot] = {"lo": lo, "rows": int(arr.shape[0]),
                            "data": np.ascontiguousarray(arr[lo:hi])}
        out["flat_store_slices"] = slices

    zero = rec.get("zero")
    if zero is not None:
        zrec = {k: zero[k] for k in ("axis", "stage", "degree",
                                     "comm_buffer_mb")}
        zbuckets = []
        for brec in zero["buckets"]:
            keep = {k: brec[k] for k in ("index", "param_keys", "sizes",
                                         "n_rows", "rows", "pad_rows")}
            keep["slots"] = {}
            for slot, srec in brec["slots"].items():
                shards = srec["shards"]
                if "lo" in srec:  # a rank's own rows (capture local=True)
                    keep["slots"][slot] = {
                        "lo": int(srec["lo"]), "rows": int(brec["rows"]),
                        "dtype": srec["dtype"], "data": shards[0]}
                    continue
                full = (shards[0] if len(shards) == 1
                        else np.concatenate(shards, axis=0))
                lo, hi = _row_slice(full.shape[0], rank, world)
                keep["slots"][slot] = {
                    "lo": lo, "rows": int(full.shape[0]),
                    "dtype": srec["dtype"],
                    "data": np.ascontiguousarray(full[lo:hi])}
            zbuckets.append(keep)
        zrec["buckets"] = zbuckets
        out["zero_slices"] = zrec
    return out


def merge_optimizer(parts):
    """Rebuild the full :func:`state.restore_optimizer` record from the
    per-rank shards (any order). Store slices concatenate in row order
    into a SHARDS LIST — restore re-flattens them for whatever live
    layout the live ranks run (elastic resume across processes)."""
    parts = sorted(parts, key=lambda r: (r.get("pod") or {}).get("rank", 0))
    merged = {}
    acc_names = None
    for rec in parts:
        for key in ("step_count", "lr", "lr_scheduler", "grads",
                    "full_layout"):
            if key in rec:
                merged[key] = rec[key]
        pod = rec.get("pod") or {}
        if pod.get("accumulator_names") is not None:
            acc_names = pod["accumulator_names"]
        if "accumulators" in rec:
            merged.setdefault("accumulators", {}).update(
                rec["accumulators"])

    if acc_names is not None:
        missing = sorted(set(acc_names) -
                         set(merged.get("accumulators", {})))
        if missing:
            raise state.StateMismatchError(
                f"pod checkpoint is missing optimizer accumulators "
                f"{missing} — a rank shard file is absent")

    with_stores = [r for r in parts if "flat_store_slices" in r]
    if with_stores:
        slots = {}
        for rec in with_stores:
            for slot, s in rec["flat_store_slices"].items():
                slots.setdefault(slot, []).append(s)
        merged["flat_stores"] = {
            slot: _concat_slices(slot, slices)
            for slot, slices in slots.items()}

    with_zero = [r for r in parts if "zero_slices" in r]
    if with_zero:
        zmeta = with_zero[0]["zero_slices"]
        buckets = []
        for bi in range(len(zmeta["buckets"])):
            brec = {k: zmeta["buckets"][bi][k]
                    for k in ("index", "param_keys", "sizes", "n_rows",
                              "rows", "pad_rows")}
            brec["slots"] = {}
            for slot in zmeta["buckets"][bi]["slots"]:
                pieces = sorted(
                    (r["zero_slices"]["buckets"][bi]["slots"][slot]
                     for r in with_zero), key=lambda s: s["lo"])
                _check_slices(f"zero bucket {brec['index']} slot {slot}",
                              pieces)
                brec["slots"][slot] = {
                    "shards": [p["data"] for p in pieces],
                    "sharded": len(pieces) > 1,
                    "dtype": pieces[0]["dtype"]}
            buckets.append(brec)
        merged["zero"] = {k: zmeta[k] for k in ("axis", "stage", "degree",
                                                "comm_buffer_mb")}
        merged["zero"]["buckets"] = buckets
    return merged


def _check_slices(what, pieces):
    expect = 0
    for p in pieces:
        if p["lo"] != expect:
            raise state.StateMismatchError(
                f"pod checkpoint {what}: row slices do not tile the "
                f"store (gap at row {expect}, next shard starts at "
                f"{p['lo']} — a rank shard file is absent)")
        expect += p["data"].shape[0]
    total = pieces[0]["rows"]
    if expect != total:
        raise state.StateMismatchError(
            f"pod checkpoint {what}: shards cover {expect} of {total} "
            "rows — a rank shard file is absent")


def _concat_slices(slot, slices):
    slices = sorted(slices, key=lambda s: s["lo"])
    _check_slices(f"flat store {slot!r}", slices)
    return (slices[0]["data"] if len(slices) == 1
            else np.concatenate([s["data"] for s in slices], axis=0))


# -- the user surface -------------------------------------------------------

class PodCheckpointManager:
    """``CheckpointManager`` for a multi-process job: each rank saves its
    shard of every registered component; rank 0 commits the manifest;
    restore merges every rank's shards from the shared filesystem (a
    dead rank's state restores from its files).

    ``rank``/``world`` default to this process's rank and world
    (``distributed.parallel_env``). ``pod``, a
    ``distributed.pod.PodRuntime``, supplies them at every call instead
    (its ``rank``, ``world_size`` and ``gen``; ``check_failures()`` turns
    a dead rank mid-save into ``RankFailedError``)."""

    def __init__(self, root, pod=None, rank=None, world=None,
                 keep_last_n=3, fs=None, include_rng=True, timeout=120.0):
        self.root = root
        self._pod = pod
        self._rank = rank
        self._world = world
        self.keep_last_n = keep_last_n
        self._fs = fs
        self._include_rng = include_rng
        self._timeout = float(timeout)
        self._models = {}
        self._optimizers = {}
        self._scalers = {}

    def _rw(self):
        if self._pod is not None:
            return self._pod.rank, self._pod.world_size
        return (parallel_env.get_rank() if self._rank is None
                else int(self._rank),
                parallel_env.get_world_size() if self._world is None
                else int(self._world))

    # -- registration (same surface as CheckpointManager) ------------------
    def add_model(self, model, name="model"):
        self._models[name] = model
        return self

    def add_optimizer(self, optimizer, name="opt"):
        self._optimizers[name] = optimizer
        return self

    def add_scaler(self, scaler, name="scaler"):
        self._scalers[name] = scaler
        return self

    # -- save / restore ----------------------------------------------------
    def save(self, step, extra_meta=None):
        rank, world = self._rw()
        staged = [n for n, m in self._models.items()
                  if state.pipeline_stage(m) is not None]
        if staged:
            raise NotImplementedError(
                f"a pod checkpoint of the pipelined model(s) {staged} is not "
                "covered (each rank holds one stage); use "
                "CheckpointManager, which writes one payload a stage")
        payloads = {}
        for name, m in self._models.items():
            payloads[f"model_{name}.pkl"] = state.dumps(partition_model(
                state.capture_model(m), rank, world))
        for name, o in self._optimizers.items():
            payloads[f"optimizer_{name}.pkl"] = state.dumps(
                partition_optimizer(state.capture_optimizer(o, local=True),
                                    rank, world))
        if rank == 0:
            for name, s in self._scalers.items():
                payloads[f"scaler_{name}.pkl"] = state.dumps(
                    state.capture_scaler(s))
            if self._include_rng:
                payloads["rng.pkl"] = state.dumps(state.capture_rng())
        meta = {"step": int(step), "time": time.time(),
                "pod": {"world": world,
                        "gen": getattr(self._pod, "gen", 0),
                        "world_ranks": list(range(world))}}
        if extra_meta:
            meta.update(extra_meta)
        return write_pod_checkpoint(
            self.root, step, payloads, rank=rank,
            world_ranks=list(range(world)), pod=self._pod, meta=meta,
            fs=self._fs, keep_last_n=self.keep_last_n,
            timeout=self._timeout)

    def restore(self, step=None, strict=True):
        """Merge every rank's shards of the newest valid pod checkpoint
        into the registered components. Returns the checkpoint meta (or
        None). The saved world may differ from the live one — that is
        the point."""
        found = read_pod_checkpoint(self.root, step=step, fs=self._fs)
        if found is None:
            return None
        # a rank dying during its restore must leave the checkpoint
        # untouched on disk: restore only ever reads
        _faults.kill_point(POD_RESTORE_KILL_POINT)
        got_step, by_rank, meta = found
        saved_ranks = sorted(by_rank)
        want = sorted((meta.get("pod") or {}).get(
            "world_ranks", saved_ranks))
        missing_ranks = sorted(set(want) - set(by_rank))
        if missing_ranks and strict:
            raise state.StateMismatchError(
                f"pod checkpoint step {got_step} is missing shard files "
                f"for rank(s) {missing_ranks}")

        def _parts(fname):
            out = []
            for r in saved_ranks:
                data = by_rank[r].get(fname)
                if data is not None:
                    out.append(state.loads(data))
            return out

        for name, m in self._models.items():
            parts = _parts(f"model_{name}.pkl")
            if not parts:
                if strict:
                    raise state.StateMismatchError(
                        f"pod checkpoint step {got_step} has no payload "
                        f"for registered model {name!r}")
                continue
            state.restore_model(m, merge_model(parts), strict=strict)
        for name, o in self._optimizers.items():
            parts = _parts(f"optimizer_{name}.pkl")
            if not parts:
                if strict:
                    raise state.StateMismatchError(
                        f"pod checkpoint step {got_step} has no payload "
                        f"for registered optimizer {name!r}")
                continue
            state.restore_optimizer(o, merge_optimizer(parts),
                                    strict=strict)
        for name, s in self._scalers.items():
            data = by_rank.get(0, {}).get(f"scaler_{name}.pkl")
            if data is not None:
                state.restore_scaler(s, state.loads(data))
            elif strict:
                raise state.StateMismatchError(
                    f"pod checkpoint step {got_step} has no payload for "
                    f"registered scaler {name!r}")
        rng = by_rank.get(0, {}).get("rng.pkl")
        if self._include_rng and rng is not None:
            state.restore_rng(state.loads(rng))
        meta = dict(meta)
        meta.setdefault("step", got_step)
        return meta

    # -- introspection -----------------------------------------------------
    def steps(self):
        return core.valid_steps(self.root, fs=self._fs)

    def latest_step(self):
        return core.latest_step(self.root, fs=self._fs)
