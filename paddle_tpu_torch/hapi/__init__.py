"""The high-level training API (counterpart: ``paddle_tpu/hapi``):
``Model`` with ``prepare``/``fit``/``evaluate``/``predict``, its callbacks,
``summary``, ``flops`` and ``hub``."""
from .model import Model, flops, summary  # noqa: F401
from . import callbacks, hub  # noqa: F401
