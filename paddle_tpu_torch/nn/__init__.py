"""Layers and functionals (counterpart: ``paddle_tpu/nn``)."""
from . import functional, initializer  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.container import LayerList  # noqa: F401
from .layer.layers import Layer  # noqa: F401
from .layer.norm import LayerNorm  # noqa: F401

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "functional", "initializer"]
