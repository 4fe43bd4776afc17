"""Optimizers and LR schedulers (counterpart: ``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]
