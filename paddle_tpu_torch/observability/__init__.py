"""Observability (counterpart: ``paddle_tpu/observability``): step
telemetry (``StepTimer``), span tracing, guarded counters and the sampled
op observer (``tracing``), the per-process JSONL run-log (``runlog``), the
crash flight recorder (``flight``), device memory accounting
(``memory``), the perf-regression gate (``gate``) and the metric exporters
with the health registry (``export``: Prometheus text, JSON, ``/metrics``
and ``/healthz``). Spans and profiler events share one buffer
(``profiler``), which :func:`export_chrome_trace` writes. Not ported: the
XLA analyses (``hlo_bytes``, ``overlap``, ``jaxpr_*``; ROADMAP item 18)."""
from .. import profiler as _profiler
from . import export, flight, gate, memory, runlog, step, tracing  # noqa: F401
from .gate import compare, load_results  # noqa: F401
from .memory import state_ledger  # noqa: F401
from .runlog import start_run, stop_run  # noqa: F401
from .step import StepTimer  # noqa: F401
from .tracing import (CATEGORIES, attach_context, count,  # noqa: F401
                      current_span, disable, enable, enabled,
                      mint_context, record_span, trace_context, trace_span)

__all__ = ["StepTimer", "enable", "disable", "enabled", "trace_span",
           "current_span", "count", "CATEGORIES", "export_chrome_trace",
           "state_ledger", "trace_context", "attach_context",
           "mint_context", "record_span", "start_run", "stop_run",
           "tracing", "runlog", "step", "export", "gate", "flight",
           "memory"]


def export_chrome_trace(path):
    """Export every recorded span and event as chrome://tracing JSON (the
    profiler's exporter: spans and profiler events share one buffer)."""
    return _profiler.export_chrome_tracing(path)


def reset():
    """Clear recorded events, the gauge board, summary windows and the
    program-memory registry (monitor counters are shared state and are
    left alone)."""
    _profiler.reset()
    export.clear_gauges()
    export.clear_summaries()
    memory.clear_program_memory()
