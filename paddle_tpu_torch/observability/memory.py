"""Device memory accounting: per-program attribution and the state ledger
(counterpart: ``paddle_tpu/observability/memory.py``).

Two views answer "where does device memory go?":

- **Per-program attribution.** The reference reads a compiled XLA
  executable's ``memory_analysis()``; the port's compiled programs are
  captured CUDA graphs (each ``jit.to_static`` unit, each serving bucket),
  and their stats are the graph pool's bytes, measured at capture
  (``StaticFunction.memory_stats()``, ``Engine.memory_stats()``), in the
  reference's kinds: argument / output / temp / alias / generated-code
  bytes and the derived ``peak_bytes``. ``record_program_memory`` keeps
  the newest record per entry; the flight recorder and the run-log
  snapshot read the registry.
- **State ledger.** A walk of the port's live state classifying every
  tensor by category (parameters, persistable buffers, optimizer moments,
  float32 masters, the ZeRO flat stores per bucket, accumulation stores,
  RNG and lr, gradients), summing the *global* logical bytes and the
  *per-rank resident* bytes (a ZeRO store holds ``rows/dp`` rows a rank).
  Byte accounting is the same on every backend.

``is_oom_error`` recognises ``torch.OutOfMemoryError`` and the CUDA
allocator's message; a flight dump of one is tagged ``reason="oom"`` and
carries :func:`flight_section`.

Not ported (they read XLA HLO; ROADMAP item 18): ``top_buffers``,
``compile_program_twin``, ``attribute_program`` and
``StaticFunction.traced_memory_stats``.
"""
import re
import threading
import weakref

import torch

__all__ = ["program_stats", "peak_bytes", "state_ledger",
           "export_state_ledger", "classify_tensor",
           "record_program_memory", "program_memory",
           "export_program_memory", "snapshot", "runlog_snapshot",
           "flight_section", "is_oom_error", "MemoryAttributionError",
           "MEMORY_KINDS", "STATE_CATEGORIES"]

MEMORY_KINDS = ("argument", "output", "temp", "alias", "generated_code")

STATE_CATEGORIES = ("param", "buffer", "opt_moment", "master",
                    "zero_param", "zero_moment", "zero_master", "gacc",
                    "rng", "lr", "hbm_cache", "grad", "host_offload",
                    "other")


class MemoryAttributionError(RuntimeError):
    """A program's memory attribution failed (not captured yet, or no
    stats to read)."""


# -- per-program attribution ----------------------------------------------

def program_stats(compiled):
    """Normalize a captured program's stats into a plain dict of
    ``{argument,output,temp,alias,generated_code}_bytes`` plus
    ``peak_bytes``. ``compiled`` is a captured program (anything with a
    ``memory_stats()`` returning those kinds, as ``jit.to_static``'s units
    do) or such a dict. Raises :class:`MemoryAttributionError` when a kind
    is missing."""
    stats = compiled if isinstance(compiled, dict) else None
    if stats is None:
        try:
            stats = compiled.memory_stats()
        except Exception as e:
            raise MemoryAttributionError(
                f"memory_stats() failed: {e}") from e
    out = {}
    for kind in MEMORY_KINDS:
        val = stats.get(f"{kind}_bytes")
        if val is None:
            raise MemoryAttributionError(
                f"memory stats lack {kind}_bytes (got {sorted(stats)})")
        out[f"{kind}_bytes"] = int(val)
    out["host_offload_bytes"] = int(stats.get("host_offload_bytes") or 0)
    out["peak_bytes"] = peak_bytes(out)
    return out


def peak_bytes(stats):
    """Arguments + outputs + temps + generated code, minus aliased bytes
    (a donated input/output pair is one buffer)."""
    return (stats["argument_bytes"] + stats["output_bytes"]
            + stats["temp_bytes"] + stats["generated_code_bytes"]
            - stats["alias_bytes"])


_programs = {}
_programs_lock = threading.Lock()


def record_program_memory(entry, stats, buffers=None):
    """Register one program's attribution under ``entry`` (the newest
    record per entry wins) and export it as
    ``program_hbm_bytes{entry=,kind=}`` gauges. Returns ``stats``."""
    rec = dict(stats)
    if buffers:
        rec["top_buffers"] = list(buffers)
    with _programs_lock:
        _programs[str(entry)] = rec
    export_program_memory(entry, stats)
    return stats


def program_memory():
    """``{entry: record}`` of every program attribution recorded in this
    process."""
    with _programs_lock:
        return {k: dict(v) for k, v in _programs.items()}


def clear_program_memory():
    with _programs_lock:
        _programs.clear()


def export_program_memory(entry, stats):
    """Export one program's byte kinds as ``program_hbm_bytes{entry=,
    kind=}`` gauges (``peak`` and ``host_offload`` included when the
    record has them)."""
    from . import export
    for kind in MEMORY_KINDS + ("peak", "host_offload"):
        val = stats.get(f"{kind}_bytes")
        if val is None:
            continue
        export.set_gauge(
            "program_hbm_bytes" + export.format_labels(
                "program_hbm_bytes", entry=entry, kind=kind),
            val)


# -- the state ledger -----------------------------------------------------

_NAME_CATEGORIES = (
    (re.compile(r"^zero_param_b\d+$"), "zero_param"),
    (re.compile(r"^zero_master_b\d+$"), "zero_master"),
    (re.compile(r"^zero_gacc_b\d+$"), "gacc"),
    (re.compile(r"^zero_\w+_b\d+$"), "zero_moment"),
    (re.compile(r"^hbm_cache_table_"), "hbm_cache"),
)

# the live optimizers (registered by Optimizer.__init__) and layers (by
# Layer.__init__, for their persistable buffers)
_optimizers = weakref.WeakSet()
_layers = weakref.WeakSet()


def register_optimizer(opt):
    _optimizers.add(opt)


def register_layer(layer):
    _layers.add(layer)


def classify_tensor(t):
    """Ledger category of a stateful tensor: an explicit
    ``_ledger_category`` tag first, then the ZeRO store names, then
    parameter / persistable buffer, else ``other``."""
    cat = getattr(t, "_ledger_category", None)
    if cat is not None:
        return cat
    name = getattr(t, "param_name", None) or ""
    for pat, c in _NAME_CATEGORIES:
        if pat.match(name):
            return c
    if isinstance(t, torch.nn.Parameter):
        return "param"
    if getattr(t, "persistable", False):
        return "buffer"
    return "other"


def _nbytes(t):
    return t.numel() * t.element_size()


def state_ledger():
    """Walk the live state into a residency ledger::

        {"categories": {cat: {"bytes": per-rank, "global_bytes",
                              "count"}},
         "entries": [{"name", "category", "shape", "dtype", "bytes",
                      "global_bytes"}],
         "total_bytes": per-rank total, "total_global_bytes": ...}

    Parameters come from the state registry (``core.state``), persistable
    buffers from the live layers, moments, masters, ``@step``/``@lr`` and
    the ZeRO stores from the live optimizers, the package generators'
    states as ``rng``; a surviving dense gradient is a ``grad`` entry. A
    ZeRO store is one rank's shard: ``bytes`` is the shard,
    ``global_bytes`` the shard times the degree. Reads metadata only."""
    from ..core import random as random_mod
    from ..core import state as state_mod
    cats = {}
    entries = []
    seen = set()
    totals = [0, 0]

    def add(name, cat, t, degree=1):
        if t is None or id(t) in seen or not isinstance(t, torch.Tensor):
            return
        seen.add(id(t))
        r = _nbytes(t)
        g = r * degree
        slot = cats.setdefault(cat, {"bytes": 0, "global_bytes": 0,
                                     "count": 0})
        slot["bytes"] += r
        slot["global_bytes"] += g
        slot["count"] += 1
        totals[0] += r
        totals[1] += g
        entries.append({"name": name, "category": cat,
                        "shape": list(t.shape),
                        "dtype": str(t.dtype).replace("torch.", ""),
                        "bytes": r, "global_bytes": g})

    for _uid, p in state_mod.snapshot():
        owner = getattr(p, "_zero_owner", None)
        if owner is not None and owner.stage == 3:
            continue  # its rows are the zero_param store's
        name = getattr(p, "param_name", None) or f"param_{_uid}"
        add(name, classify_tensor(p), p)
        g = p.grad
        if g is not None and g.layout == torch.strided:
            add(name + "@GRAD", "grad", g)
    for layer in list(_layers):
        for bname, buf in layer.named_buffers(recurse=False):
            if bname in getattr(layer, "_non_persistent_buffers_set", ()):
                continue
            add(bname, "buffer", buf)
    for opt in list(_optimizers):
        names = getattr(opt, "_names", {})
        fused = getattr(opt, "_fused", None)
        if fused is not None:  # the stores, which the views share
            for slot, t in fused.stores.items():
                add(f"fused_{slot}", "master" if slot == "master"
                    else "opt_moment", t)
        else:
            for (slot, pid), t in list(opt._accumulators.items()):
                pname = names.get(pid, str(pid))
                add(f"{pname}.{slot}", "master" if slot == "master"
                    else "opt_moment", t)
        add("@step", "lr", getattr(opt, "_step_count", None))
        lr = getattr(opt, "_lr", None)
        add("@lr", "lr", getattr(lr, "tensor", None))
        zero = getattr(opt, "_zero", None)
        if zero is not None:
            for sname, t in zero._store_items():
                cat = next((c for pat, c in _NAME_CATEGORIES
                            if pat.match(sname)), "other")
                add(sname, cat, t, degree=zero.degree)
    for dev, gen in random_mod.generators().items():
        try:
            add(f"rng:{dev}", "rng", gen.get_state())
        except RuntimeError:
            pass  # a generator inside a capture hands out no state
    entries.sort(key=lambda e: -e["bytes"])
    return {"categories": cats, "entries": entries,
            "total_bytes": totals[0], "total_global_bytes": totals[1]}


def export_state_ledger(ledger=None, rank=None):
    """Export the ledger as ``state_resident_bytes{category=}`` gauges
    plus ``state_resident_bytes_total``; returns the ledger. ``rank``
    (default ``PADDLE_TRAINER_ID`` when set) labels every gauge."""
    import os as _os

    from . import export
    ledger = ledger if ledger is not None else state_ledger()
    if rank is None:
        rank = _os.environ.get("PADDLE_TRAINER_ID")
    labels = {} if rank is None else {"rank": str(rank)}
    for cat, slot in ledger["categories"].items():
        export.set_gauge(
            "state_resident_bytes" + export.format_labels(
                "state_resident_bytes", category=cat, **labels),
            slot["bytes"])
    if labels:
        export.set_gauge(
            "state_resident_bytes_total" + export.format_labels(
                "state_resident_bytes_total", **labels),
            ledger["total_bytes"])
    else:
        export.set_gauge("state_resident_bytes_total",
                         ledger["total_bytes"])
    return ledger


# -- snapshots (run-log / flight) ------------------------------------------

def snapshot(top_n=8):
    """JSON-ready memory snapshot: per-category state bytes, the top-N
    state entries and every recorded program attribution."""
    ledger = state_ledger()
    return {
        "state": {
            "categories": {c: dict(v)
                           for c, v in ledger["categories"].items()},
            "total_bytes": ledger["total_bytes"],
            "total_global_bytes": ledger["total_global_bytes"],
            "top_entries": ledger["entries"][:top_n],
        },
        "programs": program_memory(),
    }


def runlog_snapshot(rank=None, export=False):
    """Emit a ``memory_snapshot`` event into the active run-log (no-op
    when none is active); returns the snapshot or None. Rank-tagged when
    a rank is known (``rank`` or ``PADDLE_TRAINER_ID``); ``export=True``
    also publishes the ``state_resident_bytes`` gauges."""
    import os as _os

    from . import runlog
    if runlog.active() is None:
        return None
    if rank is None:
        rank = _os.environ.get("PADDLE_TRAINER_ID")
    snap = snapshot()
    if rank is None:
        runlog.event("memory_snapshot", **snap)
    else:
        runlog.event("memory_snapshot", rank=str(rank), **snap)
    if export:
        export_state_ledger(rank=rank)
    return snap


def flight_section():
    """The crash dump's memory section: :func:`snapshot` plus the CUDA
    allocator's counters on the card. Never raises."""
    try:
        snap = snapshot()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            snap["device"] = {
                "allocated_bytes": torch.cuda.memory_allocated(),
                "reserved_bytes": torch.cuda.memory_reserved(),
                "max_allocated_bytes": torch.cuda.max_memory_allocated()}
        return snap
    except Exception as e:
        return {"error": str(e)[:300]}


# -- OOM classification ---------------------------------------------------

_OOM_RE = re.compile(
    r"CUDA out of memory|out of memory|RESOURCE[ _]EXHAUSTED|\bOOM\b"
    r"|allocation (failure|failed)|failed to allocate"
    r"|exceeds the memory capacity", re.IGNORECASE)


def is_oom_error(exc):
    """True when an exception is an allocation failure: Python
    ``MemoryError``, ``torch.OutOfMemoryError``, or any exception whose
    message matches the allocators' vocabulary ("CUDA out of memory",
    "failed to allocate", ...)."""
    if exc is None:
        return False
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return True
    try:
        return bool(_OOM_RE.search(str(exc)))
    except Exception:
        return False
