"""Op version registry (counterpart: ``paddle_tpu/core/op_version.py``,
the port's own copy with the same history): saved-model compatibility
across releases.

Reference: ``paddle/fluid/framework/op_version_registry.{h,cc}`` —
REGISTER_OP_VERSION records per-op version bumps with modification notes;
the versions are serialized with programs and checked at load, so an
artifact built by a newer op definition fails loudly instead of silently
misbehaving. ``jit/export.py`` embeds :func:`snapshot` in the ``.pdmodel``
meta and ``ServedProgram`` calls :func:`check_compatible`: older artifacts
load, newer ones are refused by name.
"""

__all__ = ["register_op_version", "get_op_version", "snapshot",
           "check_compatible", "OpVersionError"]

_registry = {}  # op_name -> (version, [notes])


class OpVersionError(RuntimeError):
    pass


def register_op_version(op_name, version, note=""):
    """reference: REGISTER_OP_VERSION(op).AddCheckpoint(note, ...)."""
    cur, notes = _registry.get(op_name, (0, []))
    if version <= cur:
        raise OpVersionError(
            f"op {op_name!r} version {version} must be > current {cur}")
    _registry[op_name] = (version, notes + [(version, note)])
    return version


def get_op_version(op_name):
    return _registry.get(op_name, (0, []))[0]


def snapshot():
    """Current {op: version} map (embedded in saved artifacts)."""
    return {k: v for k, (v, _) in _registry.items()}


def check_compatible(saved_versions):
    """Loading an artifact: every op version it was saved with must be <=
    the runtime's (reference: op_compatible_info.cc checks). Raises
    OpVersionError naming the offending ops."""
    bad = []
    for op, v in (saved_versions or {}).items():
        cur = get_op_version(op)
        if v > cur:
            bad.append(f"{op} (artifact v{v} > runtime v{cur})")
    if bad:
        raise OpVersionError(
            "model artifact was saved with newer op definitions: "
            + ", ".join(bad))


# -- version history of this framework's ops -------------------------------
# (bumped when an op's saved semantics change; v1 = first release)
register_op_version("cross_entropy", 1,
                    "fused hard-label path: logsumexp - picked")
register_op_version("nll_loss", 1, "consumes log-probabilities")
register_op_version("while", 1, "masked-scan gradient lowering")
register_op_version("conditional_block", 1, "lax.cond lowering")
register_op_version("batch_norm", 1, "running stats as explicit inputs")
register_op_version("dropout", 1, "eval variant recorded for clone(for_test)")
