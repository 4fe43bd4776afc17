"""Optimizers and LR schedulers (counterpart: ``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
