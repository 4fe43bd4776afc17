"""Step telemetry (counterpart: ``paddle_tpu/observability``)."""
from .step import StepTimer  # noqa: F401

__all__ = ["StepTimer"]
