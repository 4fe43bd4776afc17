"""Incubating APIs (counterpart: ``paddle_tpu/incubate``): the epoch-loop
``auto_checkpoint``, the Switch ``MoELayer``, ``softmax`` (the
functional's), and ``ModelAverage`` and ``LookAhead`` (the optimizer
package's)."""
from ..nn.functional import softmax  # noqa: F401
from . import auto_checkpoint, moe  # noqa: F401
from .moe import MoELayer  # noqa: F401
from ..optimizer.averaging import LookAhead, ModelAverage  # noqa: F401

__all__ = ["auto_checkpoint", "moe", "MoELayer", "softmax", "ModelAverage",
           "LookAhead"]
