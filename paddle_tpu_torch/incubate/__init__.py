"""Incubating APIs (counterpart: ``paddle_tpu/incubate``): the epoch-loop
``auto_checkpoint`` and the Switch ``MoELayer``."""
from . import auto_checkpoint, moe  # noqa: F401
from .moe import MoELayer  # noqa: F401

__all__ = ["auto_checkpoint", "moe", "MoELayer"]
