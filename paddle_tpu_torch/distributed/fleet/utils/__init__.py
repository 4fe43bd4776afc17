"""Fleet utilities (counterpart: ``paddle_tpu/distributed/fleet/utils``):
``fs.LocalFS`` and ``recompute``."""
from . import fs  # noqa: F401
from .fs import FSFileExistsError, FSFileNotExistsError, LocalFS  # noqa: F401
from .recompute import RecomputeFunction, recompute  # noqa: F401

__all__ = ["fs", "LocalFS", "FSFileExistsError", "FSFileNotExistsError",
           "recompute", "RecomputeFunction"]
