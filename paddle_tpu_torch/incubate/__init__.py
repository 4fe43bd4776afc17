"""Incubating APIs (counterpart: ``paddle_tpu/incubate``): the epoch-loop
``auto_checkpoint``."""
from . import auto_checkpoint  # noqa: F401

__all__ = ["auto_checkpoint"]
