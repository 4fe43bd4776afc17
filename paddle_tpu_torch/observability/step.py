"""StepTimer: windowed training or serving rates from the host clock
(counterpart: ``paddle_tpu/observability/step.py``).

A ``StepTimer`` marks step boundaries; over a sliding window it derives
tokens/s and examples/s (the caller gives per-step counts) and an MFU
estimate, ``flops_per_token * tokens / wall / peak_flops`` or, without a
per-token count, ``flops_per_step * steps / wall / peak_flops``, against
the ``peak_flops`` the caller passes for its device, and two fractions of
the window's wall time:

- ``compile_stall_frac``: time spent building programs, from the compile
  counters (``jit_compile_ns``: CUDA-graph captures;
  ``jit_backend_compile_ns``: nvcc builds of the kernels at first use;
  both written by ``observability.tracing.record_compile``);
- ``data_wait_frac``: time blocked on input (``dataloader_wait_ns``,
  which ``io.DataLoader`` counts while tracing is on for ``dataloader``).

Each mark publishes the window to the export board under ``publish_as``
and, when a run-log is active, writes a ``step`` event there, with a
``memory_snapshot`` event (``memory.runlog_snapshot``) once a window. The
caller synchronises the device before each ``step()`` (e.g. by reading the
loss), or the window measures the enqueue. A k-step program
(``jit.to_static(fn, scan_steps=k)``) takes one mark a call with ``tokens
= k * B * S``, as the reference's ``bench.py`` counts a window:
``step_time_ms`` is then the time of a call, k steps.
"""
import collections
import time

from .. import monitor

__all__ = ["StepTimer"]

_COMPILE_COUNTERS = ("jit_compile_ns", "jit_backend_compile_ns")
_WAIT_COUNTER = "dataloader_wait_ns"


def _compile_ns():
    return sum(monitor.stat_get(c) for c in _COMPILE_COUNTERS)


class StepTimer:
    """Call ``step(tokens=...)`` once per step; the first call only
    anchors the window start. ``telemetry()`` returns the current
    window aggregate (also returned by each later ``step()``)."""

    def __init__(self, window=20, tokens_per_step=None,
                 examples_per_step=None, flops_per_step=None,
                 flops_per_token=None, peak_flops=None, publish_as="step"):
        self.window = int(window)
        self.tokens_per_step = tokens_per_step
        self.examples_per_step = examples_per_step
        self.flops_per_step = flops_per_step
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.publish_as = publish_as
        # (dt_s, tokens, examples, wait_ns, compile_ns) per completed step
        self._window = collections.deque(maxlen=self.window)
        self.total_steps = 0
        self._t_last = None
        self._wait_last = 0
        self._compile_last = 0

    def start(self):
        """Anchor the window start (optional: the first ``step()`` call
        anchors implicitly and reports from the second on)."""
        self._t_last = time.perf_counter()
        self._wait_last = monitor.stat_get(_WAIT_COUNTER)
        self._compile_last = _compile_ns()
        return self

    def step(self, tokens=None, examples=None):
        """Mark a step boundary; returns the window telemetry (None until
        one full step has elapsed)."""
        now = time.perf_counter()
        if self._t_last is None:
            self.start()
            return None
        dt, self._t_last = now - self._t_last, now
        wait, comp = monitor.stat_get(_WAIT_COUNTER), _compile_ns()
        d_wait, self._wait_last = wait - self._wait_last, wait
        d_comp, self._compile_last = comp - self._compile_last, comp
        self._window.append(
            (dt, tokens if tokens is not None else self.tokens_per_step,
             examples if examples is not None else self.examples_per_step,
             max(d_wait, 0), max(d_comp, 0)))
        self.total_steps += 1
        t = self.telemetry()
        if self.publish_as:
            from . import export, runlog
            export.publish(self.publish_as, t)
            if runlog.active() is not None:
                runlog.event("step", name=self.publish_as,
                             **{k: round(v, 6) if isinstance(v, float)
                                else v for k, v in t.items()})
                if self.total_steps % self.window == 0:
                    from . import memory
                    try:
                        memory.runlog_snapshot()
                    except Exception:
                        pass  # telemetry never fails the step
        return t

    def telemetry(self):
        """Aggregate over the current window."""
        w = list(self._window)
        if not w:
            return {"steps_total": self.total_steps, "window_steps": 0}
        wall = sum(dt for dt, *_ in w)
        tokens = sum(tk for _, tk, *_ in w if tk is not None)
        examples = sum(ex for _, _, ex, *_ in w if ex is not None)
        wait_ns = sum(x[3] for x in w)
        comp_ns = sum(x[4] for x in w)
        out = {"steps_total": self.total_steps, "window_steps": len(w),
               "step_time_ms": wall / len(w) * 1e3,
               "data_wait_frac": (min(wait_ns / 1e9 / wall, 1.0)
                                  if wall else 0.0),
               "compile_stall_frac": (min(comp_ns / 1e9 / wall, 1.0)
                                      if wall else 0.0)}
        if not wall:
            return out
        if tokens:
            out["tokens_per_s"] = tokens / wall
        if examples:
            out["examples_per_s"] = examples / wall
        if self.peak_flops:
            if self.flops_per_token is not None and tokens:
                out["mfu"] = (self.flops_per_token * tokens / wall
                              / self.peak_flops)
            elif self.flops_per_step is not None:
                out["mfu"] = (self.flops_per_step * len(w) / wall
                              / self.peak_flops)
        return out
