"""Analyses (counterpart: ``paddle_tpu/analysis``). Only the runtime
lock-order watchdog is ported (``lockwatch``); the static program
analyses read the reference's recorded programs and XLA HLO (ROADMAP
items 17 and 18)."""
from . import lockwatch  # noqa: F401

__all__ = ["lockwatch"]
