"""StepTimer: windowed training or serving rates from the host clock
(counterpart: ``paddle_tpu/observability/step.py``).

A ``StepTimer`` marks step boundaries; over a sliding window it derives
tokens/s and examples/s (the caller gives per-step counts) and an MFU
estimate, ``flops_per_token * tokens / wall / peak_flops`` or, without a
per-token count, ``flops_per_step * steps / wall / peak_flops``, against
the ``peak_flops`` the caller passes for its device; each mark publishes
the window to the export board under ``publish_as``. The caller synchronises
the device before each ``step()`` (e.g. by reading the loss), or the window
measures the enqueue. A k-step program (``jit.to_static(fn,
scan_steps=k)``) takes one mark a call with ``tokens = k * B * S``, as the
reference's ``bench.py`` counts a window: ``step_time_ms`` is then the time
of a call, k steps. Not ported: the compile-stall and data-wait fractions
(the port has no compile or data-loader counters) and the run-log's step
events.
"""
import collections
import time

__all__ = ["StepTimer"]


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
        # (dt_s, tokens, examples) per completed step
        self._window = collections.deque(maxlen=self.window)
        self.total_steps = 0
        self._t_last = None

    def start(self):
        """Anchor the window start (optional: the first ``step()`` call
        anchors implicitly and reports from the second on)."""
        self._t_last = time.perf_counter()
        return self

    def step(self, tokens=None, examples=None):
        """Mark a step boundary; returns the window telemetry (None until
        one full step has elapsed)."""
        now = time.perf_counter()
        if self._t_last is None:
            self.start()
            return None
        dt, self._t_last = now - self._t_last, now
        self._window.append(
            (dt, tokens if tokens is not None else self.tokens_per_step,
             examples if examples is not None else self.examples_per_step))
        self.total_steps += 1
        t = self.telemetry()
        if self.publish_as:
            from . import export
            export.publish(self.publish_as, t)
        return t

    def telemetry(self):
        """Aggregate over the current window."""
        w = list(self._window)
        if not w:
            return {"steps_total": self.total_steps, "window_steps": 0}
        wall = sum(dt for dt, _, _ in w)
        tokens = sum(tk for _, tk, _ in w if tk is not None)
        examples = sum(ex for _, _, ex in w if ex is not None)
        out = {"steps_total": self.total_steps, "window_steps": len(w),
               "step_time_ms": wall / len(w) * 1e3}
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
