"""Fleet utilities (counterpart: ``paddle_tpu/distributed/fleet/utils``):
``fs.LocalFS``."""
from . import fs  # noqa: F401
from .fs import FSFileExistsError, FSFileNotExistsError, LocalFS  # noqa: F401

__all__ = ["fs", "LocalFS", "FSFileExistsError", "FSFileNotExistsError"]
