"""Observability (counterpart: ``paddle_tpu/observability``): step
telemetry (``StepTimer``), span tracing and guarded counters
(``tracing``), the per-process JSONL run-log (``runlog``) and the metric
exporters with the health registry (``export``: Prometheus text, JSON,
``/metrics`` and ``/healthz``). Not ported: the flight recorder, the
memory registry, the perf gate and the XLA analyses (``ROADMAP.md`` item
16)."""
from . import export, runlog, step, tracing  # noqa: F401
from .runlog import start_run, stop_run  # noqa: F401
from .step import StepTimer  # noqa: F401
from .tracing import (CATEGORIES, attach_context, count,  # noqa: F401
                      current_span, disable, enable, enabled,
                      mint_context, record_span, trace_context, trace_span)

__all__ = ["StepTimer", "enable", "disable", "enabled", "trace_span",
           "current_span", "count", "CATEGORIES", "trace_context",
           "attach_context", "mint_context", "record_span", "start_run",
           "stop_run", "tracing", "runlog", "step", "export"]
