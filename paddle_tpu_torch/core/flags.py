"""Global flags (counterpart: ``paddle_tpu/core/flags.py``; the reference's
``platform/flags.cc`` registry behind ``paddle.set_flags`` and
``paddle.get_flags``, with the ``FLAGS_*`` environment variables as
overrides).

The port keeps the registry in Python (the reference mirrors its native
runtime's store). ``FLAGS_check_nan_inf`` installs the reference's
post-op NaN/Inf observer, which goes with the op observer of ROADMAP
item 16: turning it on raises until then.
"""
import os

__all__ = ["set_flags", "get_flags"]

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
        if k == "FLAGS_check_nan_inf" and _truthy(v):
            raise NotImplementedError(
                "FLAGS_check_nan_inf needs the op observer, which waits in "
                "ROADMAP item 16")
        _flags[k] = v


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
