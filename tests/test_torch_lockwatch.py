"""The lock-order watchdog (``_lockwatch``, ``analysis.lockwatch``)
against the reference's.

- The same lock-order inversion (A then B on one thread, B then A on
  another) is reported the same way by both: the edge that closed the
  cycle, the cycle's names, the held set and the snapshot's sections.
- Disarmed, the factories return the raw ``threading`` primitives.
- The metric exporters' locks are the watchdog's, under the reference's
  names.
"""
import threading

import pytest

from paddle_tpu import _lockwatch as ref_lw
from paddle_tpu_torch import _lockwatch as lw
from paddle_tpu_torch.analysis import lockwatch as public


@pytest.fixture(autouse=True)
def _armed():
    was = (lw.enable(), ref_lw.enable())
    lw.reset()
    ref_lw.reset()
    yield
    lw.reset()
    ref_lw.reset()
    if not was[0]:
        lw.disable()
    if not was[1]:
        ref_lw.disable()


def _invert(mod):
    a, b = mod.Lock(name="test.a"), mod.Lock(name="test.b")
    with a:
        with b:
            assert mod.held_names() == ["test.a", "test.b"]

    def other():
        with b:
            with a:
                pass
    t = threading.Thread(target=other, name="inverter")
    t.start()
    t.join()
    return mod.violations(), mod.snapshot()


def test_inversion_is_reported_as_the_reference_reports_it():
    want, want_snap = _invert(ref_lw)
    got, got_snap = _invert(lw)
    assert len(got) == len(want) == 1
    for key in ("edge", "cycle", "thread", "held"):
        assert got[0][key] == want[0][key], key
    assert got[0]["cycle"] == ["test.b", "test.a", "test.b"]
    assert set(got[0]) == set(want[0])
    assert set(got_snap) == set(want_snap)
    assert [(e["from"], e["to"]) for e in got_snap["edges"]] == \
        [(e["from"], e["to"]) for e in want_snap["edges"]]


def test_consistent_order_is_no_violation():
    a, b = lw.Lock(name="test.a"), lw.RLock(name="test.b")
    for _ in range(3):
        with a, b:
            pass
    cv = lw.Condition(name="test.cv")
    with cv:
        cv.notify_all()
    assert lw.violations() == []


def test_disarmed_factories_are_raw():
    lw.disable()
    assert type(lw.Lock()) is type(threading.Lock())
    assert type(public.RLock()) is type(threading.RLock())
    assert lw.held_names() == []


def test_public_surface_and_exporter_locks():
    assert public.Lock is lw.Lock and public.snapshot is lw.snapshot
    names = {"Lock", "RLock", "Condition", "enable", "disable", "enabled",
             "reset", "held_names", "violations", "snapshot"}
    assert names <= set(public.__all__)
    from paddle_tpu_torch.observability import export
    summary = export.Summary("test_lat", window=4)  # armed: watched
    assert summary._lock._name == "metrics.summary"
