"""Capture and restore of the whole training state (counterpart:
``paddle_tpu/checkpoint/state.py``).

What a step checkpoint holds: the model's ``state_dict`` entries, the
optimizer's moments and float32 masters (the per-parameter accumulators,
or the ZeRO flat stores as per-rank shards), stage 3's ``param`` stores
(its parameters are views that the model section skips and only names),
the window accumulator ``gacc`` of stages 2/3 and the gradients that
survive a step (an accumulation window's phase), ``@step`` and ``@lr``
and the scheduler, the GradScaler's state, and the package's random
generators.

The payloads are the reference's: pickled numpy arrays under structural
keys, the ``state_dict`` path for the model and ``"<group>.<index>.<slot>"``
for the optimizer's slots, ZeRO buckets as records with ``rows``,
``pad_rows``, ``sizes``, ``n_rows`` and each slot's list of per-rank
shards. The port's ZeRO layout is the reference's, so either package
restores what the other wrote, at any dp degree (elastic resume: the
saved shards are concatenated, the old degree's padding rows trimmed, and
this rank's rows of the live degree's padded layout copied in). bfloat16
arrays are ``ml_dtypes.bfloat16`` where that package is installed, as the
reference writes them, else widened to float32 (exact; a restore casts to
the live tensor's dtype).

Under tensor parallelism (parameters split over the mp group, ``split_axis``
set) the checkpoint holds the reference's full layout, so it crosses to
the reference's single-process model: each split parameter is gathered
from the mp group in its own dtype (``bridge.gather_full``) and a restore
takes this rank's slice again (``bridge.local_slice``). The optimizer's
record is then the per-parameter one (``"full_layout": True``): every
moment and master gathered the same way, a ZeRO-1 store first gathered
over its group and cut into its parameters; a restore cuts this rank's
slice and, under ZeRO, writes this rank's rows of the stores. ZeRO-2/3
over a mesh with tensor parallelism is not covered and raises.

The one deliberate difference is the random state: a JAX threefry key and
torch's Philox generators cannot be carried across, so the port writes its
generators' states under a key the reference's record lacks, and restoring
the other package's record raises :class:`StateMismatchError`
(``include_rng=False`` is the way across).

With tracing's ``checkpoint`` category on, the copies between the card and
the host are counted (``checkpoint_d2h_ns``/``_bytes`` and
``checkpoint_h2d_ns``/``_bytes`` in ``monitor``): the share of a save or a
restore that they take.

Every restore writes into the live tensors in place (``copy_``), never by
rebinding: a program whose CUDA graph was captured before the restore
reads the same addresses and continues from the restored state. Stage 3
gathers its parameter buffers again afterwards.
"""
import io
import pickle

import numpy as np
import torch

from ..observability import tracing as _obs

__all__ = ["capture_model", "restore_model", "capture_optimizer",
           "pipeline_stage", "splits_parameters",
           "restore_optimizer", "capture_scaler", "restore_scaler",
           "capture_rng", "restore_rng", "dumps", "loads", "to_numpy",
           "from_numpy", "StateMismatchError"]


class StateMismatchError(RuntimeError):
    """The live objects don't structurally match the checkpoint."""


def dumps(obj):
    return pickle.dumps(obj, protocol=4)


def loads(data):
    return pickle.load(io.BytesIO(data))


def _bfloat16():
    """numpy's bfloat16 dtype (``ml_dtypes``), or None where it is not
    installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


class _transfer:
    """Count a copy between the card and the host while tracing's
    ``checkpoint`` category is on: ``checkpoint_<kind>_ns`` and
    ``checkpoint_<kind>_bytes`` (``kind``: ``d2h`` or ``h2d``)."""

    def __init__(self, kind, t):
        self.kind = kind
        self.nbytes = t.numel() * t.element_size()
        self.on = t.is_cuda and _obs.enabled("checkpoint")

    def __enter__(self):
        if self.on:
            self.t0 = _obs.now_ns()
        return self

    def __exit__(self, *exc):
        if self.on:
            _obs.count(f"checkpoint_{self.kind}_ns", _obs.now_ns() - self.t0,
                       cat="checkpoint")
            _obs.count(f"checkpoint_{self.kind}_bytes", self.nbytes,
                       cat="checkpoint")
        return False


def to_numpy(t):
    """A host copy of tensor ``t`` as a numpy array (never a view of it);
    bfloat16 as ``ml_dtypes.bfloat16`` where available, else float32."""
    t = t.detach()
    with _transfer("d2h", t):
        if t.dtype != torch.bfloat16:
            return t.to("cpu", copy=True).numpy()
        bf16 = _bfloat16()
        if bf16 is None:
            return t.to("cpu", torch.float32, copy=True).numpy()
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(bf16)


def from_numpy(arr):
    """A CPU tensor holding numpy array ``arr`` (``ml_dtypes.bfloat16``
    included)."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _copy_into(live, arr, what):
    """Write ``arr`` into tensor ``live`` in place, cast to its dtype."""
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(live.shape):
        raise StateMismatchError(f"{what}: checkpoint shape "
                                 f"{tuple(arr.shape)} vs live "
                                 f"{tuple(live.shape)}")
    with torch.no_grad(), _transfer("h2d", live):
        live.copy_(from_numpy(arr))


def _zero3_param(t):
    owner = getattr(t, "_zero_owner", None)
    return owner is not None and owner.stage == 3


def _split(t):
    """Whether ``t`` is a parameter split over more than one mp rank."""
    from ..bridge import _sliced
    return _sliced(t) and t.split_degree > 1


def _full(t, param):
    """``t`` (the parameter ``param`` or one of its slots) in the full
    layout: gathered from the mp group where ``param`` is split."""
    from ..bridge import gather_full
    return gather_full(t, param) if _split(param) else t


def _local(arr, param):
    """This rank's slice of a full-layout array for ``param``."""
    from ..bridge import local_slice
    return local_slice(arr, param) if _split(param) else arr


# -- model -----------------------------------------------------------------

def capture_model(model):
    """Host copies of the model's ``state_dict`` entries by structural
    name, each split parameter in the full layout (every rank of its mp
    group calls this). Stage 3's parameters are views of buffers that its
    optimizer's ``param`` stores fill, so they are recorded by name only (a
    restore checks that a restored optimizer covers them)."""
    state, zero3 = {}, []
    for name, t in model.state_dict(keep_vars=True).items():
        if _zero3_param(t):
            zero3.append(name)
            continue
        state[name] = to_numpy(_full(t, t))
    return {"state": state, "zero3_params": zero3}


def restore_model(model, data, strict=True):
    own = model.state_dict(keep_vars=True)
    saved = data["state"]
    missing = []
    for name, t in own.items():
        if name in saved:
            _copy_into(t, _local(saved[name], t), f"model entry {name!r}")
        elif not _zero3_param(t):  # stage 3: restored from its stores
            missing.append(name)
    if strict and missing:
        raise StateMismatchError(
            f"checkpoint is missing model entries {missing}")
    return missing


# -- optimizer -------------------------------------------------------------

def _indexed_params(opt):
    """[(key, param)] with structural '<group>.<index>' keys."""
    return [(f"{gi}.{pi}", p) for gi, group in enumerate(opt._param_groups)
            for pi, p in enumerate(group["params"])]


def pipeline_stage(model):
    """(this rank's stage, the number of stages) of a pipelined model
    (``PipelineLayer`` over more than one stage, wrapped or not), else
    None."""
    from ..bridge import _inner
    from ..distributed.fleet.meta_parallel.pp_layers import PipelineLayer
    inner = _inner(model)
    if isinstance(inner, PipelineLayer) and inner.num_stages > 1:
        return inner.stage_id, inner.num_stages
    return None


def splits_parameters(opt):
    """Whether any parameter of ``opt`` is split over an mp group."""
    return any(_split(p) for p in opt._parameters())


def capture_optimizer(opt, local=False):
    """The optimizer's state as the reference records it. Under ZeRO each
    store is gathered from every rank of its group (each rank calls this)
    into the per-rank shards list; ``local=True`` keeps only this rank's
    shard, with its first row as ``lo`` (a multi-process checkpoint's
    partition, ``multihost.partition_optimizer``). Over split parameters
    the record is the per-parameter full layout (:func:`_capture_full`)."""
    out = {"step_count": to_numpy(opt._step_count),
           "lr": to_numpy(opt._lr.tensor)}
    if opt._lr.scheduler is not None:
        out["lr_scheduler"] = opt._lr.scheduler.state_dict()
    params = _indexed_params(opt)
    key_of = {id(p): k for k, p in params}
    if splits_parameters(opt):
        return _capture_full(opt, params, out)
    # the accumulation window's phase: gradients that survived the last
    # step, which the window's next micro steps add to
    out["grads"] = {key: to_numpy(p.grad) for key, p in params
                    if p.grad is not None and not p.grad.is_sparse}
    zero = opt._zero
    if zero is None:
        fused = _fused_slots(opt)
        out["accumulators"] = {
            f"{key_of[pid]}.{slot}": to_numpy(t)
            for (slot, pid), t in opt._accumulators.items()
            if pid in key_of and slot not in fused}
        out["flat_stores"] = {slot: to_numpy(t) for slot, t in fused.items()}
        return out
    buckets = []
    for b in zero.buckets:
        brec = {"index": b.index,
                "param_keys": [key_of.get(id(p)) for p in b.params],
                "sizes": list(b.sizes), "n_rows": list(b.n_rows),
                "rows": b.rows, "pad_rows": b.pad_rows, "slots": {}}
        for slot, t in b.stores.items():
            shards = ([to_numpy(t)] if local
                      else [to_numpy(s) for s in zero.gather_shards(t)])
            rec = {"shards": shards, "sharded": zero.degree > 1,
                   "dtype": np.dtype(shards[0].dtype).str}
            if local:
                rec["lo"] = zero.rank * b.shard_rows
            brec["slots"][slot] = rec
        buckets.append(brec)
    out["zero"] = {"axis": zero.axis, "stage": zero.stage,
                   "degree": zero.degree,
                   "comm_buffer_mb": zero.comm_buffer_mb, "buckets": buckets}
    return out


def _capture_full(opt, params, out):
    """The per-parameter record in the reference's full layout: each
    gradient, moment and master gathered from the mp group where its
    parameter is split; a ZeRO-1 store gathered over its group first and
    cut into its parameters' segments."""
    zero = opt._zero
    if zero is not None and zero.stage > 1:
        raise NotImplementedError(
            f"a checkpoint of ZeRO-{zero.stage} over the {zero.axis!r} axis "
            "with tensor-parallel (mp-split) parameters is not covered; "
            "ZeRO-1 is")
    out["full_layout"] = True
    out["grads"] = {key: to_numpy(_full(p.grad, p)) for key, p in params
                    if p.grad is not None and not p.grad.is_sparse}
    key_of = {id(p): k for k, p in params}
    by_id = {id(p): p for _, p in params}
    acc = {}
    for (slot, pid), t in opt._accumulators.items():
        if pid in key_of:
            acc[f"{key_of[pid]}.{slot}"] = to_numpy(_full(t, by_id[pid]))
    for b in zero.buckets if zero is not None else ():
        for slot, store in b.stores.items():
            full = torch.cat(zero.gather_shards(store))
            for p, seg in zip(b.params, b.segments(full)):
                acc[f"{key_of[id(p)]}.{slot}"] = to_numpy(_full(seg, p))
    out["accumulators"] = acc
    out["flat_stores"] = {}
    return out


def _restore_full(opt, params, data, strict):
    """Restore a :func:`_capture_full` record: this rank's slice of each
    slot, into the accumulators or this rank's rows of the ZeRO stores."""
    acc = data.get("accumulators", {})
    zero = opt._zero
    live = {f"{k}.{slot}" for k, p in params.items()
            for (slot, pid) in opt._accumulators if pid == id(p)}
    if zero is not None:
        key_of = {id(p): k for k, p in params.items()}
        for b in zero.buckets:
            for slot, store in b.stores.items():
                keys = [f"{key_of[id(p)]}.{slot}" for p in b.params]
                live.update(keys)
                gone = [k for k in keys if k not in acc]
                if gone:
                    raise StateMismatchError(
                        f"the checkpoint has no {slot!r} for {gone}")
                vals = [from_numpy(_local(acc[k], p)).to(store.device)
                        for k, p in zip(keys, b.params)]
                with torch.no_grad(), _transfer("h2d", store):
                    store.copy_(b.local(b.flatten(vals, store.dtype,
                                                  store.device)))
    unknown = sorted(set(acc) - live)
    if unknown and strict:
        raise StateMismatchError(
            f"checkpoint accumulators {unknown} have no live slot")
    for key, p in params.items():
        for (slot, pid), t in opt._accumulators.items():
            name = f"{key}.{slot}"
            if pid == id(p) and name in acc:
                _copy_into(t, _local(acc[name], p), f"accumulator {name!r}")
    if zero is not None:
        zero.refresh_parameters()


def _restore_store(zero, b, live, brec, srec):
    """Write this rank's rows of a saved store into the live shard: the
    saved shards concatenated, the saved degree's padding rows trimmed,
    the rest of the live degree's rows zero (its padding)."""
    rows_logical = brec["rows"] - brec["pad_rows"]
    shards = srec["shards"]
    full = shards[0] if len(shards) == 1 else np.concatenate(shards, axis=0)
    if full.shape[0] < rows_logical:
        raise StateMismatchError(
            f"ZeRO bucket {b.index}: checkpoint holds {full.shape[0]} rows, "
            f"its layout needs {rows_logical} (a rank's shards missing?)")
    if b.rows < rows_logical:
        raise StateMismatchError(
            f"ZeRO bucket {b.index}: live layout has {b.rows} rows < the "
            f"checkpoint's {rows_logical} logical rows")
    lo = zero.rank * b.shard_rows
    part = full[lo:min(lo + b.shard_rows, rows_logical)]
    if part.shape[1:] != tuple(live.shape[1:]):
        raise StateMismatchError(
            f"ZeRO bucket {b.index}: row width {part.shape[1:]} vs "
            f"{tuple(live.shape[1:])}")
    with torch.no_grad(), _transfer("h2d", live):
        n = part.shape[0]
        if n:
            live[:n].copy_(from_numpy(part))
        live[n:].zero_()


def restore_optimizer(opt, data, strict=True):
    """Restore into the live optimizer, in place."""
    # the scheduler first: its set_state_dict writes its rate into the lr
    # tensor, and the saved lr then wins (they normally agree)
    if "lr_scheduler" in data and opt._lr.scheduler is not None:
        opt._lr.scheduler.set_state_dict(data["lr_scheduler"])
    opt._lr.set(float(np.asarray(data["lr"], np.float32)))
    _copy_into(opt._step_count, data["step_count"], "@step")

    params = dict(_indexed_params(opt))
    grads = data.get("grads", {})
    unknown = sorted(set(grads) - set(params))
    if unknown and strict:
        raise StateMismatchError(
            f"checkpoint gradients for unknown parameter slots {unknown}")
    with torch.no_grad():
        for key, p in params.items():
            if key not in grads:
                # the checkpoint's window holds no gradient here: one left
                # from before the restore must not join the next step
                p.grad = None
                continue
            g = from_numpy(_local(grads[key], p)).to(device=p.device,
                                                      dtype=p.dtype)
            if tuple(g.shape) != tuple(p.shape):
                raise StateMismatchError(
                    f"gradient {key!r}: shape {tuple(g.shape)} vs "
                    f"{tuple(p.shape)}")
            if p.grad is not None:
                p.grad.copy_(g)
            else:
                p.grad = g

    if data.get("full_layout"):
        return _restore_full(opt, params, data, strict)
    zero = opt._zero
    saved_zero = data.get("zero")
    if (zero is None) != (saved_zero is None):
        raise StateMismatchError(
            "checkpoint and live optimizer disagree on ZeRO sharding: "
            f"checkpoint {'has' if saved_zero else 'lacks'} sharded "
            "stores; enable the same _zero_enable(stage=...) before "
            "restore")
    if saved_zero is None:
        _restore_accumulators(opt, params, data, strict)
        return
    if saved_zero["stage"] != zero.stage or saved_zero["axis"] != zero.axis:
        raise StateMismatchError(
            f"ZeRO config mismatch: checkpoint stage="
            f"{saved_zero['stage']} axis={saved_zero['axis']!r}, live "
            f"stage={zero.stage} axis={zero.axis!r}")
    if len(saved_zero["buckets"]) != len(zero.buckets):
        raise StateMismatchError(
            f"bucket layout mismatch: checkpoint has "
            f"{len(saved_zero['buckets'])} buckets, live optimizer "
            f"{len(zero.buckets)} (comm_buffer_mb must match: checkpoint "
            f"{saved_zero['comm_buffer_mb']}, live {zero.comm_buffer_mb})")
    for b, brec in zip(zero.buckets, saved_zero["buckets"]):
        if list(b.sizes) != list(brec["sizes"]) \
                or list(b.n_rows) != list(brec["n_rows"]):
            raise StateMismatchError(
                f"bucket {b.index}: per-param row layout differs from the "
                "checkpoint (param set or ordering changed)")
        for slot, srec in brec["slots"].items():
            live = b.stores.get(slot)
            if live is None:
                raise StateMismatchError(
                    f"bucket {b.index}: checkpoint slot {slot!r} has no "
                    "live store (stage/master config mismatch)")
            _restore_store(zero, b, live, brec, srec)
        extra = set(b.stores) - set(brec["slots"])
        if strict and extra:
            raise StateMismatchError(
                f"bucket {b.index}: live slots {sorted(extra)} are absent "
                "from the checkpoint")
    # stage 3: the parameters (and the prefetch slot, bucket 0's buffer)
    # are gathers of the param stores just written
    zero.refresh_parameters()


def _fused_slots(opt):
    """``{slot: store}`` of the fused stores (``fuse_accumulators``) that
    the reference fuses too: every slot but the masters, which it keeps
    per parameter (and so does the record)."""
    fused = opt._fused
    if fused is None:
        return {}
    return {slot: t for slot, t in fused.stores.items() if slot != "master"}


def _restore_accumulators(opt, params, data, strict):
    key_of = {id(p): k for k, p in params.items()}
    fused = _fused_slots(opt)
    live = {f"{key_of[pid]}.{slot}": t
            for (slot, pid), t in opt._accumulators.items()
            if pid in key_of and slot not in fused}
    for key, arr in data.get("accumulators", {}).items():
        t = live.get(key)
        if t is None:
            if strict:
                raise StateMismatchError(
                    f"checkpoint accumulator {key!r} has no live slot "
                    "(different optimizer class or param set?)")
            continue
        _copy_into(t, arr, f"accumulator {key!r}")
    for slot, arr in data.get("flat_stores", {}).items():
        store = fused.get(slot)
        if store is None:
            raise StateMismatchError(
                f"checkpoint fused store {slot!r} has no live counterpart "
                "(fuse_accumulators mismatch)")
        _copy_into(store, arr, f"fused store {slot!r}")
    if strict and fused and not data.get("flat_stores"):
        raise StateMismatchError(
            "the live optimizer keeps fused stores (fuse_accumulators) and "
            "the checkpoint none (fuse_accumulators mismatch)")


# -- scaler / rng ----------------------------------------------------------

def capture_scaler(scaler):
    return {"scale": to_numpy(scaler._scale),
            "good_steps": to_numpy(scaler._good_steps),
            "bad_steps": to_numpy(scaler._bad_steps),
            "enable": scaler._enable}


def restore_scaler(scaler, data):
    scaler.load_state_dict({k: data[k] for k in
                            ("scale", "good_steps", "bad_steps")})


def capture_rng():
    """The states of the package's generators, by device, and its seed
    (``core.random``), under a key the reference's record lacks."""
    from ..core import random as core_random
    return {"torch_generators": core_random.capture_state()}


def restore_rng(data):
    """Set the package's generators to a :func:`capture_rng` record, in
    place, so a generator registered with a captured graph draws from the
    restored state at the next replay."""
    from ..core import random as core_random
    if "torch_generators" not in data:
        raise StateMismatchError(
            "the checkpoint's random state is another package's (a JAX "
            f"threefry key, record keys {sorted(data)}), which torch's "
            "Philox generators cannot take; restore with include_rng=False")
    core_random.restore_state(data["torch_generators"])
