"""Step-granular, shard-aware, crash-consistent training checkpoints
(counterpart: ``paddle_tpu/checkpoint``).

- **Atomic publish** (``checkpoint.core``): staged writes, a sha256 per
  file in a manifest written last, fsync and one ``rename(2)``, keep-last-N
  GC: a crash at any write stage leaves the previous checkpoint or the new
  one, never a torn one.
- **Shard-aware state** (``checkpoint.state``): the ZeRO-1/2/3 flat
  stores are saved as per-rank shards and restored by re-flattening, at
  another dp degree too (elastic resume).
- **Bitwise resume**: parameters, moments, float32 masters, the
  GradScaler, the random generators, the lr scheduler, ``@step`` and the
  accumulation window's phase (surviving gradients and ``gacc``) all
  round-trip, in place, so the restored job's losses are bit for bit an
  uninterrupted run's, and a program whose CUDA graph is already captured
  continues from the restored state.
- **Multi-process** (``checkpoint.multihost``): per-rank shard files under
  a manifest that rank 0 commits.

The files are the reference's (``state.py``), so a checkpoint moves
between ``paddle_tpu`` and ``paddle_tpu_torch`` with ``include_rng=False``.

Typical use::

    mgr = checkpoint.CheckpointManager("ckpt", keep_last_n=3)
    mgr.add_model(model).add_optimizer(opt).add_scaler(scaler)
    meta = mgr.restore()            # None on a fresh job
    start = (meta["step"] + 1) if meta else 0
    for step in range(start, total):
        train_step(...)
        if step % 100 == 99:
            mgr.save(step)

In a distributed job every rank of the active mesh calls ``save`` and
``restore``, and the mesh's first rank alone writes: the ZeRO stores are
gathered from the ranks of their group, and every rank restores its own
rows. Under tensor parallelism the split parameters (and their moments
and masters) are gathered from the mp group into the reference's full
layout, and every rank restores its own slice (``state``). A pipelined model (``PipelineLayer`` over more than one
stage) writes one payload a stage, ``model_<name>.stage<s>.pkl`` (and its
optimizer's, ``optimizer_<name>.stage<s>.pkl``), sent to the writer; each
rank restores its stage's. Combinations not covered raise at ``save``,
before anything is written: ZeRO-2/3 with tensor parallelism, a pipeline
with ZeRO or with tensor parallelism. The random state saved is rank 0's
generators (not the tensor-parallel tracker's per-rank states).
"""
import os
import time

import torch
import torch.distributed as dist

from ..distributed import parallel_env
from ..observability import tracing as _obs
from . import core, multihost, state  # noqa: F401
from .core import (CheckpointCorruptError, CheckpointError,  # noqa: F401
                   gc_checkpoints, latest_step, read_checkpoint,
                   valid_steps, write_checkpoint)
from .multihost import (PodCheckpointError,  # noqa: F401
                        PodCheckpointManager, read_pod_checkpoint,
                        write_pod_checkpoint)
from .state import StateMismatchError  # noqa: F401

__all__ = ["CheckpointManager", "CheckpointError", "CheckpointCorruptError",
           "StateMismatchError", "write_checkpoint", "read_checkpoint",
           "valid_steps", "latest_step", "gc_checkpoints", "core", "state",
           "multihost", "PodCheckpointManager", "PodCheckpointError",
           "write_pod_checkpoint", "read_pod_checkpoint"]


class CheckpointManager:
    """Register the training job's stateful components once, then
    ``save(step)`` / ``restore()``. One payload file per component keeps
    corruption localized in the manifest's content hashes."""

    def __init__(self, root, keep_last_n=3, fs=None, include_rng=True):
        self.root = root
        self.keep_last_n = keep_last_n
        self._fs = fs
        self._include_rng = include_rng
        self._models = {}
        self._optimizers = {}
        self._scalers = {}

    # -- registration ------------------------------------------------------
    def add_model(self, model, name="model"):
        self._models[name] = model
        return self

    def add_optimizer(self, optimizer, name="opt"):
        self._optimizers[name] = optimizer
        return self

    def add_scaler(self, scaler, name="scaler"):
        self._scalers[name] = scaler
        return self

    # -- the writer --------------------------------------------------------
    def _group(self):
        """The process group the save spans (its rank 0 writes): the
        active mesh's (a hybrid mesh spans the default group; a mesh over a
        subgroup, that subgroup), else the default group; None without a
        process group."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        mesh = parallel_env.current_mesh()
        if mesh is not None and mesh.group is not None:
            return mesh.group
        return dist.group.WORLD

    def _pipeline(self):
        """(this rank's stage, the number of stages) of the registered
        pipelined models, else None; raises for the combinations a
        checkpoint does not cover."""
        stages = {state.pipeline_stage(m) for m in self._models.values()}
        stages.discard(None)
        split = [n for n, o in self._optimizers.items()
                 if state.splits_parameters(o)]
        for name, o in self._optimizers.items():
            if o._zero is not None and o._zero.stage > 1 and split:
                raise NotImplementedError(
                    f"a checkpoint of ZeRO-{o._zero.stage} (optimizer "
                    f"{name!r}) with tensor-parallel (mp-split) parameters "
                    "is not covered; ZeRO-1 is")
        if not stages:
            return None
        if len(stages) > 1:
            raise NotImplementedError(
                f"registered models disagree on their pipeline stage: "
                f"{sorted(stages)}")
        zero = [n for n, o in self._optimizers.items() if o._zero is not None]
        if zero or split:
            raise NotImplementedError(
                "a checkpoint of a pipelined model with "
                + (f"ZeRO (optimizer(s) {zero})" if zero else
                   "tensor-parallel (mp-split) parameters")
                + " is not covered; a pipeline over replicated or dp "
                "optimizers is")
        return stages.pop()

    @staticmethod
    def _payload(kind, name, stage):
        if stage is None:
            return f"{kind}_{name}.pkl"
        return f"{kind}_{name}.stage{stage[0]}.pkl"

    @staticmethod
    def _collect(payloads, group):
        """Every stage's payloads at the writer: each stage's first data-
        and model-parallel rank sends its own (the others hold copies)."""
        from ..distributed.fleet.base.topology import \
            get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        sends = hcg is None or (hcg.get_data_parallel_rank() == 0
                                and hcg.get_model_parallel_rank() == 0)
        mine = payloads if sends else {}
        gathered = ([None] * dist.get_world_size(group)
                    if dist.get_rank(group) == 0 else None)
        dist.gather_object(mine, gathered,
                           dst=dist.get_global_rank(group, 0), group=group)
        if gathered is None:
            return payloads
        out = {}
        for part in gathered:
            for k, v in part.items():
                out.setdefault(k, v)
        return out

    def _agree(self, group, ok):
        """Whether every rank of ``group`` is ``ok`` (the writer: it
        published), on every rank of it."""
        if group is None or dist.get_world_size(group) == 1:
            return ok
        device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        flag = torch.tensor([0.0 if ok else 1.0], device=device)
        dist.all_reduce(flag, group=group)
        return float(flag) == 0.0

    # -- save / restore ----------------------------------------------------
    def save(self, step, extra_meta=None):
        """Capture every registered component and atomically publish
        checkpoint ``step``. Returns the published directory. Every rank
        of a distributed job calls it."""
        group = self._group()
        stage = self._pipeline()
        payloads = {}
        zero_meta = {}
        with _obs.trace_span("checkpoint/capture", cat="checkpoint",
                             step=step):
            for name, m in self._models.items():
                payloads[self._payload("model", name, stage)] = state.dumps(
                    state.capture_model(m))
            for name, o in self._optimizers.items():
                rec = state.capture_optimizer(o)
                payloads[self._payload("optimizer", name, stage)] = \
                    state.dumps(rec)
                if "zero" in rec:
                    z = rec["zero"]
                    zero_meta[name] = {"stage": z["stage"], "axis": z["axis"],
                                       "degree": z["degree"]}
            for name, s in self._scalers.items():
                payloads[f"scaler_{name}.pkl"] = state.dumps(
                    state.capture_scaler(s))
            if self._include_rng:
                payloads["rng.pkl"] = state.dumps(state.capture_rng())
            if stage is not None and group is not None:
                payloads = self._collect(payloads, group)
        meta = {"step": int(step), "time": time.time(),
                "components": sorted(payloads), "zero": zero_meta}
        if stage is not None:
            meta["pipeline_stages"] = stage[1]
        if extra_meta:
            meta.update(extra_meta)
        final = os.path.join(self.root, core.step_dirname(step))
        failed = None
        if group is None or dist.get_rank(group) == 0:
            try:
                final = core.write_checkpoint(
                    self.root, step, payloads, meta=meta, fs=self._fs,
                    keep_last_n=self.keep_last_n)
            except BaseException as e:  # re-raised once every rank knows
                failed = e
        published = self._agree(group, failed is None)
        if failed is not None:
            raise failed
        if not published:
            raise CheckpointError(f"checkpoint step {step}: the writing rank "
                                  "failed to publish it")
        return final

    def restore(self, step=None, strict=True):
        """Restore the newest valid checkpoint (or an explicit ``step``)
        into the registered components, in place. Returns the checkpoint
        meta dict, or ``None`` when no valid checkpoint exists."""
        found = core.read_checkpoint(self.root, step=step, fs=self._fs)
        if found is None:
            return None
        got_step, payloads, meta = found
        stage = self._pipeline()
        saved_stages = meta.get("pipeline_stages")
        if (stage[1] if stage else None) != saved_stages:
            raise StateMismatchError(
                f"checkpoint step {got_step} was written by "
                f"{saved_stages or 'no'} pipeline stages, the live model has "
                f"{stage[1] if stage else 'none'}")

        def _load(fname, what):
            data = payloads.get(fname)
            if data is None:
                if strict:
                    raise StateMismatchError(
                        f"checkpoint step {got_step} has no payload for "
                        f"registered {what} ({fname!r})")
                return None
            return state.loads(data)

        zero3_by_model = {}
        for name, m in self._models.items():
            rec = _load(self._payload("model", name, stage),
                        f"model {name!r}")
            if rec is not None:
                state.restore_model(m, rec, strict=strict)
                zero3_by_model[name] = rec.get("zero3_params", [])
        covered = set()
        for name, o in self._optimizers.items():
            rec = _load(self._payload("optimizer", name, stage),
                        f"optimizer {name!r}")
            if rec is not None:
                state.restore_optimizer(o, rec, strict=strict)
                if "zero" in rec and o._zero.stage == 3:
                    covered.update(id(p) for b in o._zero.buckets
                                   for p in b.params)
        if strict:
            _check_zero3_covered(self._models, zero3_by_model, covered)
        for name, s in self._scalers.items():
            rec = _load(f"scaler_{name}.pkl", f"scaler {name!r}")
            if rec is not None:
                state.restore_scaler(s, rec)
        if self._include_rng and "rng.pkl" in payloads:
            state.restore_rng(state.loads(payloads["rng.pkl"]))
        meta = dict(meta)
        meta.setdefault("step", got_step)
        return meta

    # -- introspection -----------------------------------------------------
    def steps(self):
        return core.valid_steps(self.root, fs=self._fs)

    def latest_step(self):
        return core.latest_step(self.root, fs=self._fs)


def _check_zero3_covered(models, zero3_by_model, covered):
    """Every parameter the checkpoint saved as a ZeRO-3 store view must be
    one whose stage-3 ``param`` store a restored optimizer wrote, or its
    weights would silently keep their fresh initialization."""
    for mname, names in zero3_by_model.items():
        if not names:
            continue
        live = models[mname].state_dict(keep_vars=True)
        for pname in names:
            if id(live.get(pname)) not in covered:
                raise StateMismatchError(
                    f"model {mname!r} param {pname!r} was saved as a ZeRO-3 "
                    "store view but no restored optimizer's sharded param "
                    "store covers it: register the stage-3 optimizer with "
                    "add_optimizer() before restore, or its weights would "
                    "silently keep their fresh initialization")
