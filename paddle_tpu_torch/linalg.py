"""Linear algebra (counterpart: ``paddle_tpu/linalg.py``): ``norm``, the
op of ``ops.math``. The rest of the reference's module waits in ROADMAP
item 17."""
from .ops.math import norm  # noqa: F401

__all__ = ["norm"]
