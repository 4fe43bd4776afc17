"""The crash flight recorder against the reference.

- A dump written for the same reason after the same spans has the
  reference's sections (format, reason, pid, time, thread, spans, metrics,
  memory, faults; lockwatch while armed; the exception) and the same
  ring of span names.
- A fired kill point dumps when the recorder is installed (a repaired
  gap: the port's kill points left only a span and a run-log event), with
  the kill point named, in both packages; a ``FaultInjected`` at a
  checkpoint kill point of a real save leaves one dump with the span
  ring, the memory section and the lockwatch section.
- ``torch.OutOfMemoryError`` and the CUDA allocator's message classify as
  out of memory, and a dump of one is tagged ``reason="oom"``; the
  reference classifies the same messages alike.
- An exception escaping a thread dumps through the chained hook.
"""
import json
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import observability as ref_obs
from paddle_tpu.observability import flight as ref_flight
from paddle_tpu.observability import memory as ref_memory
from paddle_tpu.testing import faults as ref_faults
from paddle_tpu_torch import _lockwatch, observability
from paddle_tpu_torch.observability import flight, memory
from paddle_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _clean():
    flight.clear()
    ref_flight.clear()
    yield
    flight.uninstall()
    ref_flight.uninstall()
    observability.disable()
    ref_obs.disable()
    faults.clear()
    ref_faults.clear()


def _spans(obs):
    obs.enable(categories=["user"])
    for name in ("load", "step", "save"):
        with obs.trace_span(name, cat="user"):
            pass
    obs.disable()


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_dump_has_the_reference_sections(tmp_path):
    _spans(ref_obs)
    ref_flight.install(str(tmp_path / "ref"))
    want = _read(ref_flight.dump("manual", exc=ValueError("boom")))
    _spans(observability)
    flight.install(str(tmp_path / "port"))
    got = _read(flight.dump("manual", exc=ValueError("boom")))
    assert set(got) == set(want)
    assert got["reason"] == want["reason"] == "manual"
    assert [s["name"] for s in got["spans"]] == \
        [s["name"] for s in want["spans"]] == ["load", "step", "save"]
    assert set(got["exception"]) == set(want["exception"])
    assert got["exception"]["message"] == "boom"
    assert set(got["memory"]) >= {"state", "programs"}
    assert flight.latest_dump() == flight.latest_dump(str(tmp_path / "port"))


def test_no_dump_when_not_installed():
    assert flight.dump("manual") is None
    assert not flight.installed()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_fired_kill_point_dumps(tmp_path, pkg):
    fl, fa = (flight, faults) if pkg == "port" else (ref_flight, ref_faults)
    fl.install(str(tmp_path))
    with fa.scoped("checkpoint/data_partial"):
        with pytest.raises(fa.FaultInjected):
            fa.kill_point("checkpoint/data_partial")
    rec = _read(fl.latest_dump())
    assert rec["reason"] == "kill_point"
    assert rec["kill_point"] == "checkpoint/data_partial"
    assert rec["spans"][-1]["name"] == "fault/checkpoint/data_partial"
    assert rec["exception"]["type"] == "FaultInjected"


def test_checkpoint_kill_point_dump_has_ring_memory_and_lockwatch(tmp_path):
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.checkpoint import CheckpointManager
    was = _lockwatch.enable()
    try:
        model = nn.Linear(8, 4, device="cpu")
        opt = optimizer.AdamW(parameters=model.parameters())
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.add_model(model).add_optimizer(opt)
        flight.install(str(tmp_path / "flight"))
        observability.enable()
        with faults.scoped("checkpoint/data_partial"):
            with pytest.raises(faults.FaultInjected):
                mgr.save(3)
    finally:
        observability.disable()
        if not was:
            _lockwatch.disable()
    dumps = sorted((tmp_path / "flight").glob("flight_*.json"))
    assert len(dumps) == 1
    rec = _read(dumps[0])
    names = [s["name"] for s in rec["spans"]]
    assert names[-1] == "fault/checkpoint/data_partial"
    assert "checkpoint/capture" in names
    led = rec["memory"]["state"]["categories"]
    assert led["param"]["bytes"] >= (8 * 4 + 4) * 4
    assert "opt_moment" in led
    assert set(rec["lockwatch"]) >= {"edges", "violations"}


OOM_CASES = [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"),
    MemoryError(),
    RuntimeError("failed to allocate 4096 bytes"),
]


@pytest.mark.parametrize("exc", OOM_CASES, ids=lambda e: type(e).__name__)
def test_oom_classification(tmp_path, exc):
    assert memory.is_oom_error(exc)
    if not isinstance(exc, torch.OutOfMemoryError):
        assert ref_memory.is_oom_error(exc)
    flight.install(str(tmp_path))
    rec = _read(flight.dump("unhandled_exception", exc=exc))
    assert rec["reason"] == "oom" and rec["cause"] == "unhandled_exception"


def test_not_oom():
    for exc in (ValueError("shape mismatch"), None,
                RuntimeError("an illegal memory access was encountered")):
        assert memory.is_oom_error(exc) == ref_memory.is_oom_error(exc)
        assert not memory.is_oom_error(exc)


def test_thread_exception_dumps_through_the_hook(tmp_path):
    flight.install(str(tmp_path))
    seen = []
    prev = threading.excepthook  # the recorder's hook (installed first)
    threading.excepthook = lambda args: (seen.append(args.exc_type),
                                         prev(args))
    try:
        t = threading.Thread(target=lambda: 1 / 0, name="dies")
        t.start()
        t.join()
    finally:
        threading.excepthook = prev
    rec = _read(flight.latest_dump())
    assert seen == [ZeroDivisionError]
    assert rec["reason"] == "unhandled_thread_exception"
    assert rec["thread"] == "dies"
    assert rec["exception"]["type"] == "ZeroDivisionError"


def test_ring_is_bounded():
    flight.set_ring_size(16)
    try:
        for i in range(40):
            flight.record(f"s{i}", "user", i, i + 1, 1, i + 1, 0)
        names = [s["name"] for s in flight.recent_spans()]
        assert names == [f"s{i}" for i in range(24, 40)]
    finally:
        flight.set_ring_size(flight.DEFAULT_RING)
    assert np.all(np.diff([s["t0"] for s in flight.recent_spans()]) > 0)
