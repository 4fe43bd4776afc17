"""Test harnesses shipped with the package (counterpart:
``paddle_tpu/testing``): ``faults``, the deterministic fault injection
that the checkpoint writers' kill points fire. The virtual pod is not
ported."""
from . import faults  # noqa: F401

__all__ = ["faults"]
