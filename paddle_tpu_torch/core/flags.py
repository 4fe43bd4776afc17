"""Global flags (counterpart: ``paddle_tpu/core/flags.py``; the reference's
``platform/flags.cc`` registry behind ``paddle.set_flags`` and
``paddle.get_flags``, with the ``FLAGS_*`` environment variables as
overrides).

The port keeps the registry in Python (the reference mirrors its native
runtime's store). ``FLAGS_check_nan_inf`` (the environment variable too,
read at import) installs the reference's post-op observer
(:class:`NanInfObserver`) at the op seam (``core.dispatch``): every
observed op's floating outputs are scanned and the first non-finite value
raises ``FloatingPointError`` naming the op. The count runs on the
tensor's device (one reduction) and is read back once per output: a host
sync per op, the debug mode's cost, as in the reference.
"""
import os

import torch

from . import dispatch

__all__ = ["set_flags", "get_flags", "NanInfObserver"]

_flags = {}

_KNOWN_DEFAULTS = {
    "FLAGS_check_nan_inf": "0",
    "FLAGS_benchmark": "0",
    "FLAGS_eager_delete_tensor_gb": "0",
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_fraction_of_gpu_memory_to_use": "0",
    "FLAGS_use_system_allocator": "0",
    "FLAGS_paddle_num_threads": "1",
}


def _truthy(v):
    return str(v).lower() not in ("0", "false", "", "none")


def set_flags(flags):
    """``set_flags({"FLAGS_benchmark": 1})``."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of FLAGS_* -> value")
    for k, v in flags.items():
        v = ("1" if v else "0") if isinstance(v, bool) else str(v)
        _flags[k] = v
        if k == "FLAGS_check_nan_inf":
            _sync_nan_check()


def get_flags(flags):
    """``get_flags(["FLAGS_benchmark"])`` -> ``{name: value}`` (ints and
    floats parsed)."""
    if isinstance(flags, str):
        flags = [flags]
    return {k: _coerce(_get(k)) for k in flags}


def _get(name):
    if name in _flags:
        return _flags[name]
    if name in os.environ:
        return os.environ[name]
    return _KNOWN_DEFAULTS.get(name)


def _coerce(v):
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


_FLOATING = {torch.float32: "float32", torch.float64: "float64",
             torch.bfloat16: "bfloat16", torch.float16: "float16"}


class NanInfObserver:
    """Post-op output scan (the reference's ``CheckVarHasNanOrInf``):
    raises on the first output holding a NaN or an Inf, naming the op,
    the output's index, the count, the shape and the dtype."""

    def begin(self, name):
        return None

    def end(self, token, name, outputs):
        for i, o in enumerate(outputs):
            if not isinstance(o, torch.Tensor):
                continue
            kind = _FLOATING.get(o.dtype)
            if kind is None:
                continue
            bad = _count_nonfinite(o)
            if bad:
                raise FloatingPointError(
                    f"Operator `{name}` output {i} contains {bad} NaN/Inf "
                    f"value(s) (shape {tuple(o.shape)}, dtype {kind}). "
                    f"Set FLAGS_check_nan_inf=0 to disable this check.")


def _count_nonfinite(t):
    """Non-finite elements of ``t``: one reduction on its device, one host
    read. A failed scan raises (the check never carries on without it)."""
    with torch.no_grad():
        t = t.detach()
        if t.layout != torch.strided:
            t = t.to_dense()
        return int(torch.count_nonzero(~torch.isfinite(t)).item())


def _sync_nan_check():
    if _truthy(_get("FLAGS_check_nan_inf")):
        dispatch.add_observer("nan_inf", NanInfObserver())
    else:
        dispatch.remove_observer("nan_inf")


# honour the environment variable at import, as gflags parses it
if _truthy(os.environ.get("FLAGS_check_nan_inf", "0")):
    _flags["FLAGS_check_nan_inf"] = "1"
    _sync_nan_check()
