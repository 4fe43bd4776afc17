"""The profiler, the one event buffer and the compile events against the
reference.

- The same spans, ``RecordEvent`` ranges and profiled ``ops`` calls give
  chrome-trace files whose events carry the reference's keys (``name``,
  ``cat``, ``ph``, ``ts``, ``dur``, ``pid``, ``tid``) with the same
  (name, cat, ph) in the same order, and summaries over the same names and
  call counts. Tracing keeps no buffer of its own: its spans are the
  profiler's events.
- The event cap counts what it drops, as the reference's does.
- ``StepTimer``'s compile-stall fraction from the same compile-counter
  increments on the same (fake) clock equals the reference's (relative
  1e-12), is above 0 in the window holding a compile and 0 after; the
  port's nvcc builds and CUDA-graph captures are its compile events.
"""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu import monitor as ref_monitor
from paddle_tpu import observability as ref_obs
from paddle_tpu import profiler as ref_prof
from paddle_tpu_torch import monitor, observability, profiler
from paddle_tpu_torch.observability import tracing

KEYS = {"name", "cat", "ph", "ts", "dur", "pid", "tid"}


@pytest.fixture(autouse=True)
def _clean():
    profiler.reset()
    ref_prof.reset()
    yield
    observability.disable()
    ref_obs.disable()
    profiler.reset()
    ref_prof.reset()


def _drive(obs, prof, mod, tensor):
    obs.enable(categories=["user"])
    with obs.trace_span("outer", cat="user", step=1):
        with obs.trace_span("inner", cat="user"):
            pass
    with prof.RecordEvent("record"):
        pass
    x = tensor(np.linspace(0.1, 1.0, 6).astype(np.float32))
    prof.start_profiler("CPU")
    mod.exp(x)
    mod.add(x, x)
    mod.exp(x)
    prof.stop_profiler()
    obs.disable()


def test_chrome_export_has_the_reference_events_and_keys(tmp_path):
    _drive(ref_obs, ref_prof, paddle, paddle.to_tensor)
    _drive(observability, profiler, pt,
           lambda a: pt.to_tensor(torch.from_numpy(a), place="cpu"))
    want_n = ref_prof.export_chrome_tracing(str(tmp_path / "ref.json"))
    got_n = observability.export_chrome_trace(str(tmp_path / "port.json"))
    want = json.loads((tmp_path / "ref.json").read_text())["traceEvents"]
    got = json.loads((tmp_path / "port.json").read_text())["traceEvents"]
    assert got_n == want_n == len(got) == len(want) == 6
    for ev in got + want:
        assert KEYS <= set(ev), ev
    assert [(e["name"], e["cat"], e["ph"]) for e in got] == \
        [(e["name"], e["cat"], e["ph"]) for e in want]
    outer = next(e for e in got if e["name"] == "outer")
    inner = next(e for e in got if e["name"] == "inner")
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]
    assert outer["args"]["step"] == 1


def test_summary_rows_match_the_reference():
    _drive(ref_obs, ref_prof, paddle, paddle.to_tensor)
    _drive(observability, profiler, pt,
           lambda a: pt.to_tensor(torch.from_numpy(a), place="cpu"))

    def rows(text):
        return sorted((ln.split()[0], int(ln.split()[1]))
                      for ln in text.splitlines()[1:])
    assert rows(profiler.summary()) == rows(ref_prof.summary())
    assert ("exp", 2) in rows(profiler.summary())


def test_tracing_spans_live_in_the_profiler_buffer():
    observability.enable(categories=["user"])
    with tracing.trace_span("a", cat="user"):
        pass
    observability.disable()
    assert [s["name"] for s in tracing.spans()] == ["a"]
    assert [e[0] for e in profiler.events()] == ["a"]
    tracing.reset()
    assert tracing.spans() == [] and profiler.events() == []


def test_event_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiler, "_MAX_EVENTS", 3)
    monkeypatch.setattr(ref_prof, "_MAX_EVENTS", 3)
    for prof in (profiler, ref_prof):
        prof.start_profiler("CPU")
        for i in range(5):
            with prof.RecordEvent(f"e{i}"):
                pass
        prof.stop_profiler()
    assert profiler.dropped_events() == ref_prof.dropped_events() == 2
    assert len(profiler.events()) == 3
    profiler.reset()
    assert profiler.dropped_events() == 0


def test_profiler_class_and_context_manager(tmp_path):
    x = pt.to_tensor(torch.ones(4), place="cpu")
    with profiler.Profiler(trace_dir=str(tmp_path)) as prof:
        pt.exp(x)
        prof.step()
    assert prof.state == "All"  # a trace directory asks for the device
    assert "exp" in prof.summary()
    assert prof.export(str(tmp_path / "t.json")) >= 1
    assert list(tmp_path.glob("trace_*.json"))
    with profiler.profiler("CPU", sorted_key=None):
        pt.tanh(x)
    assert "tanh" in profiler.summary()
    assert profiler.Profiler(targets=["CPU"]).state == "CPU"


def test_compile_stall_fraction_matches_the_reference(monkeypatch):
    """One compile of 0.2 s inside the second window: both timers read
    the same fractions, > 0 there and 0 in the next window."""
    from paddle_tpu.observability.step import StepTimer as RefTimer
    from paddle_tpu_torch.observability import StepTimer
    ticks = iter(np.cumsum([0.0, 0.5, 0.5, 0.5, 0.5]))
    clock = {}
    monkeypatch.setattr(time, "perf_counter", lambda: clock["now"])
    ref, port = RefTimer(window=1, publish_as=None), StepTimer(
        window=1, publish_as=None)
    observability.enable(categories=["jit"])
    fracs = []
    for i in range(5):
        clock["now"] = next(ticks)
        if i == 2:
            ref_monitor.stat_add("jit_compile_ns", 200_000_000)
            t0 = tracing.now_ns()
            tracing.record_compile("capture", t0, t0 + 200_000_000)
        want, got = ref.step(), port.step()
        if want is None:
            assert got is None
            continue
        for key in ("compile_stall_frac", "data_wait_frac"):
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
        fracs.append(got["compile_stall_frac"])
    observability.disable()
    assert fracs == [0.0, pytest.approx(0.4), 0.0, 0.0]
    assert [s["name"] for s in tracing.spans()] == ["jit/capture"]


def test_compile_events_are_counted_only_under_the_jit_category():
    before = monitor.stat_get("jit_backend_compiles")
    tracing.record_compile("backend", 0, 10)
    assert monitor.stat_get("jit_backend_compiles") == before
    observability.enable(categories=["jit"])
    tracing.record_compile("backend", 0, 10)
    with pytest.raises(ValueError):
        tracing.record_compile("link", 0, 1)
    observability.disable()
    assert monitor.stat_get("jit_backend_compiles") == before + 1
