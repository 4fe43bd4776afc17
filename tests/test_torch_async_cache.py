"""The port's async cache pipeline against the reference's, on the CPU: the
cases of ``tests/test_async_cache.py``, each scenario run through both
packages (the ``WriteBackQueue`` on one recording client each, the caches
each on its own package's server) with the same observations asserted
equal, plus the CTR pipeline: ``prefetch=True`` bitwise ``prefetch=False``
(losses, dense parameters and the server's rows after the flush), at the
uncached per-batch PS path within ``UNCACHED_ATOL`` (the reference's own
bound) and at the reference's losses within ``REF_RTOL`` (dense weights
carried across with ``bridge``; float32 in two libraries).
"""
import gc
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as ref_monitor
from paddle_tpu.distributed import ps as ref_ps
from paddle_tpu.distributed.ps.communicator import \
    SyncCommunicator as RefSync
from paddle_tpu.distributed.ps.embedding import \
    reset_registry as ref_reset
from paddle_tpu.models import ctr as ref_ctr
import paddle_tpu_torch as pt
from paddle_tpu_torch import bridge, monitor
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps.communicator import SyncCommunicator
from paddle_tpu_torch.distributed.ps.embedding import (deterministic_init,
                                                       flush_sparse_grads,
                                                       reset_registry)
from paddle_tpu_torch.models import ctr
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.testing import faults

DIM = 4
RTOL = 1e-5
UNCACHED_ATOL = 1e-6
REF_RTOL = 1e-4
PKGS = {"port": (ps, monitor), "ref": (ref_ps, ref_monitor)}


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(2)
    faults.reset()
    yield
    faults.reset()
    # the registries hold the embedding layers, and through their
    # communicators the dense parameters: drop them, so no later test
    # of this process sees them in the state ledger
    reset_registry()
    ref_reset()
    gc.collect()


class _FakeClient:
    """A recording client; an optional gate blocks pushes."""

    def __init__(self, gate=None, fail_times=0):
        self.pushes = []
        self.gate = gate
        self.fail_times = fail_times
        self._mu = threading.Lock()

    def push_sparse_delta(self, table, keys, deltas):
        if self.gate is not None:
            self.gate.wait()
        with self._mu:
            if self.fail_times > 0:
                self.fail_times -= 1
                raise ConnectionError("injected push failure")
            self.pushes.append((table, np.array(keys, copy=True),
                                np.array(deltas, copy=True)))


def _both(scenario):
    """``scenario(pkg, monitor)`` through both packages; returns the
    port's observations after asserting them equal to the reference's."""
    got = {k: scenario(*PKGS[k]) for k in ("ref", "port")}
    assert got["port"] == got["ref"]
    return got["port"]


def _pushes(cli, table=None):
    return [(t, k.tolist(), d.tolist()) for t, k, d in cli.pushes
            if table is None or t == table]


def test_write_back_coalesces_duplicate_keys_by_summation():
    def run(pkg, mon):
        gate = threading.Event()
        cli = _FakeClient(gate=gate)
        wb = pkg.WriteBackQueue(cli, range_bits=32)
        try:
            # wedge the worker on one batch so the next two coalesce
            wb.put(9, [0], np.zeros((1, DIM), np.float32))
            deadline = time.monotonic() + 10
            while not wb._inflight and time.monotonic() < deadline:
                time.sleep(0.005)
            wb.put(7, [1, 2], np.ones((2, DIM), np.float32))
            wb.put(7, [2, 3], 2 * np.ones((2, DIM), np.float32))
            gate.set()
            wb.flush()
        finally:
            gate.set()
            wb.stop(flush=False)
        return _pushes(cli, 7), wb.pushed_rows, wb.coalesced_rows

    pushes, pushed, coalesced = _both(run)
    assert pushes == [(7, [1, 2, 3], [[1.0] * DIM, [3.0] * DIM,
                                      [2.0] * DIM])]
    assert pushed == 5 and coalesced == 1


def test_write_back_splits_key_ranges_and_caps_rows():
    def run(pkg, mon):
        cli = _FakeClient()
        wb = pkg.WriteBackQueue(cli, range_bits=2, max_rows_per_push=3)
        try:
            keys = np.array([0, 1, 2, 3, 4, 5, 100], np.uint64)
            wb.put(1, keys, np.ones((keys.size, DIM), np.float32))
            wb.flush()
        finally:
            wb.stop(flush=False)
        return [k for _t, k, _d in _pushes(cli)]

    chunks = _both(run)
    assert all(len(k) <= 3 and len({x >> 2 for x in k}) == 1
               for k in chunks)
    assert sorted(sum(chunks, [])) == [0, 1, 2, 3, 4, 5, 100]


def test_write_back_backpressure_blocks_put_at_the_watermark():
    def run(pkg, mon):
        gate = threading.Event()
        cli = _FakeClient(gate=gate)
        wb = pkg.WriteBackQueue(cli, max_pending_rows=8)
        mon.stat_reset("hbm_writeback_backpressure")
        try:
            wb.put(1, np.arange(8, dtype=np.uint64),
                   np.ones((8, DIM), np.float32))
            done = threading.Event()

            def producer():
                wb.put(1, np.arange(8, 12, dtype=np.uint64),
                       np.ones((4, DIM), np.float32))
                done.set()

            threading.Thread(target=producer, daemon=True).start()
            blocked = not done.wait(timeout=0.5)
            pressed = mon.stat_get("hbm_writeback_backpressure") >= 1
            bounded = wb.pending_rows <= 12
            gate.set()
            released = done.wait(timeout=10.0)
            wb.flush()
        finally:
            gate.set()
            wb.stop(flush=False)
        return blocked, pressed, bounded, released, wb.pushed_rows

    assert _both(run) == (True, True, True, True, 12)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_write_back_worker_death_requeues_then_restart_pushes_once():
    def run(pkg, mon):
        cli = _FakeClient(fail_times=1)
        wb = pkg.WriteBackQueue(cli)
        raised = []
        try:
            wb.put(1, [5], np.ones((1, DIM), np.float32))
            deadline = time.monotonic() + 10
            while wb._error is None and time.monotonic() < deadline:
                time.sleep(0.01)
            pending = wb.pending_rows
            for call in (lambda: wb.put(1, [6], np.ones((1, DIM),
                                                        np.float32)),
                         wb.flush):
                try:
                    call()
                except RuntimeError as e:
                    raised.append("restart" in str(e))
            wb.restart()
            wb.flush()
        finally:
            wb.stop(flush=False)
        return pending, raised, len(cli.pushes), wb.pushed_rows

    assert _both(run) == (1, [True, True], 1, 1)


def test_write_back_put_after_stop_raises_and_restart_revives():
    def run(pkg, mon):
        cli = _FakeClient()
        wb = pkg.WriteBackQueue(cli)
        wb.stop()
        try:
            wb.put(1, [1], np.ones((1, DIM), np.float32))
            raised = False
        except RuntimeError as e:
            raised = "stopped" in str(e)
        wb.restart()
        try:
            wb.put(1, [1], np.ones((1, DIM), np.float32))
            wb.flush()
        finally:
            wb.stop(flush=False)
        return raised, wb.pushed_rows, len(cli.pushes)

    assert _both(run) == (True, 1, 1)


def test_write_back_has_pending_is_the_read_your_writes_signal():
    def run(pkg, mon):
        gate = threading.Event()
        wb = pkg.WriteBackQueue(_FakeClient(gate=gate))
        try:
            wb.put(3, [10, 11], np.ones((2, DIM), np.float32))
            out = [wb.has_pending(3, [11]), wb.has_pending(3, [12]),
                   wb.has_pending(4, [11])]
            gate.set()
            wb.flush()
            out.append(wb.has_pending(3, [11]))
        finally:
            gate.set()
            wb.stop(flush=False)
        return out

    assert _both(run) == [True, False, False, False]


class _Side:
    def __init__(self, pkg, capacity, table_id=1000, lr=0.1, writeback=None,
                 **kw):
        self.srv = pkg.PsServer([pkg.TableConfig(
            table_id, "sparse", DIM, "sgd", lr=lr, init_range=0.1,
            seed=table_id)], port=0)
        self.cli = pkg.PsClient([f"127.0.0.1:{self.srv.start()}"])
        self.cli.register_sparse(table_id, DIM)
        if pkg is ps:
            kw["device"] = "cpu"
        self.cache = pkg.HbmEmbeddingCache(self.cli, table_id, DIM, capacity,
                                           optimizer="sgd", lr=lr,
                                           writeback=writeback, **kw)
        self.pkg = pkg
        self.to = torch.from_numpy if pkg is ps else paddle.to_tensor

    def table(self):
        t = self.cache.table
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    def train(self, ids):
        """lookup + sum backward + apply_grads."""
        out = self.cache.lookup(self.to(np.asarray(ids, np.int64)))
        (out.sum() if self.pkg is ps else paddle.ops.sum(out)).backward()
        self.cache.apply_grads()

    def close(self):
        self.cli.stop_servers()
        self.cli.close()
        self.srv.stop()


@pytest.mark.chaos
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_write_back_kill_dumps_and_restart_applies_exactly_once(tmp_path):
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import flight
    profiler.reset()
    flight.clear()
    obs.enable()
    flight.install(str(tmp_path / "flight"))
    side = _Side(ps, 16)
    wb = ps.WriteBackQueue(side.cli)
    try:
        keys = np.array([2, 4], np.uint64)
        before = side.cli.pull_sparse(1000, keys)
        faults.inject("ps/writeback", times=1)
        wb.put(1000, keys, np.full((2, DIM), 0.5, np.float32))
        deadline = time.monotonic() + 10
        while wb._error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert isinstance(wb._error, faults.FaultInjected)
        wb._thread.join(timeout=10)
        assert wb.pending_rows == 2  # requeued, nothing on the wire
        np.testing.assert_array_equal(side.cli.pull_sparse(1000, keys),
                                      before)
        d = os.path.dirname(flight.latest_dump())
        recs = [json.load(open(os.path.join(d, f)))
                for f in sorted(os.listdir(d)) if f.endswith(".json")]
        kp = [r for r in recs if r["reason"] == "kill_point"]
        assert kp and kp[-1]["kill_point"] == "ps/writeback"
        assert kp[-1]["spans"][-1]["name"] == "fault/ps/writeback"
        th = [r for r in recs if r["reason"] == "unhandled_thread_exception"]
        assert th and th[-1]["thread"] == "hbm-cache-writeback"
        wb.restart()
        wb.flush()
        np.testing.assert_allclose(side.cli.pull_sparse(1000, keys),
                                   before + 0.5, rtol=1e-6, atol=1e-7)
    finally:
        wb.stop(flush=False)
        side.close()
        obs.disable()
        flight.uninstall()
        flight.clear()
        profiler.reset()


def _pair(scenario, capacity, **kw):
    out = {}
    for name in ("ref", "port"):
        side = _Side(PKGS[name][0], capacity, **kw)
        try:
            out[name] = scenario(side)
        finally:
            side.close()
    return out


def test_prefetcher_plans_in_order_while_the_consumer_computes():
    mirror = deterministic_init(1000, np.arange(64, dtype=np.uint64), DIM,
                                0.1)
    wins = [np.arange(i * 8, i * 8 + 8, dtype=np.int64).reshape(2, 4)
            for i in range(3)]

    def run(side):
        pf = side.pkg.CachePrefetcher(side.cache, depth=2, bucket=8)
        got = []
        try:
            for w in wins:
                pf.submit(w)
            for _ in wins:
                plan = pf.take()
                slots, inv = (np.asarray(t.numpy()) for t in plan.feeds())
                tbl = side.table()
                got.append(np.stack(
                    [tbl[slots[i]][inv[i].reshape(-1)].reshape(4, DIM)
                     for i in range(2)]))
                side.cache.drain_window(plan)
            assert 0.0 <= pf.overlap_efficiency() <= 1.0
            return got, pf.windows, list(side.cache._slots.items())
        finally:
            pf.close()

    out = _pair(run, 64)
    got, windows, slots = out["port"]
    assert windows == 3 and slots == out["ref"][2]
    for g, r, w in zip(got, out["ref"][0], wins):
        np.testing.assert_allclose(g, mirror[w], rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-7)


def test_planner_error_surfaces_on_take_then_submit():
    def run(side):
        pf = side.pkg.CachePrefetcher(side.cache, depth=1)
        msgs = []
        pf.submit(np.arange(9, dtype=np.int64).reshape(1, 9))
        for call in (lambda: pf.take(timeout=10),
                     lambda: pf.submit(np.zeros((1, 1), np.int64))):
            try:
                call()
            except RuntimeError as e:
                msgs.append(str(e))
        return msgs

    out = _pair(run, 8)  # 9 uniques over capacity - 1 = 7 rows
    assert out["port"] == out["ref"] == ["cache prefetcher failed"] * 2


def test_close_releases_unconsumed_plans_and_a_blocked_worker():
    def run(side):
        pf = side.pkg.CachePrefetcher(side.cache, depth=1)
        for i in range(3):
            pf.submit(np.arange(i * 4, i * 4 + 4, dtype=np.int64)
                      .reshape(1, 4))
        deadline = time.monotonic() + 10
        while pf.windows < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        t0 = time.monotonic()
        pf.close()
        quick = time.monotonic() - t0 < 15
        try:
            pf.take(timeout=1)
            closed = False
        except RuntimeError as e:
            closed = "closed" in str(e)
        return (pf.windows >= 2, quick, pf._thread.is_alive(),
                dict(side.cache._plan_pins), closed)

    out = _pair(run, 64)
    assert out["port"] == out["ref"] == (True, True, False, {}, True)


def test_window_pins_block_eviction_until_release():
    def run(side):
        cache, to = side.cache, side.to
        plan = cache.plan_window(np.array([[1, 2, 3, 4]], np.int64),
                                 bucket=4)
        del_ = cache.lookup(to(np.array([[10, 11, 12, 13]], np.int64)))
        del del_
        kept = {1, 2, 3, 4} <= set(cache._slots)
        try:
            cache.lookup(to(np.array([[20, 21, 22, 23, 24]], np.int64)))
            raised = False
        except RuntimeError as e:
            raised = "pinned" in str(e)
        intact = {1, 2, 3, 4, 10, 11, 12, 13} <= set(cache._slots)
        plan.release()
        cache.lookup(to(np.array([[20, 21, 22, 23]], np.int64)))
        return (kept, raised, intact, sorted(cache._slots),
                cache._free == [])

    out = _pair(run, 9)
    assert out["port"] == out["ref"]
    kept, raised, intact, slots, _ = out["port"]
    assert kept and raised and intact
    assert not {1, 2, 3, 4} & set(slots) and {10, 11, 12, 13} <= set(slots)


def test_a_replanned_dirty_key_keeps_its_local_training():
    mirror = deterministic_init(1000, np.arange(8, dtype=np.uint64), DIM,
                                0.1)

    def run(side):
        cache = side.cache
        side.train([[1, 2]])
        plan1 = cache.plan_window(np.array([[3, 4, 5, 6, 7]], np.int64),
                                  bucket=8)
        deferred = 1 not in cache._slots and bool(cache._pending_evict)
        plan2 = cache.plan_window(np.array([[1]], np.int64), bucket=2)
        moved = 1 in cache._slots and bool(cache._pending_copy)
        plan2.feeds()
        flushed = not cache._pending_copy and \
            not cache._pending_install_slots
        row1 = side.table()[cache._slots[1]].copy()
        row2_server = side.cli.pull_sparse(1000, np.array([2], np.uint64))[0]
        cache.end_pass()
        row1_server = side.cli.pull_sparse(1000, np.array([1], np.uint64))[0]
        plan1.release()
        plan2.release()
        return (deferred, moved, flushed), row1, row2_server, row1_server

    out = _pair(run, 7)
    assert out["port"][0] == out["ref"][0] == (True, True, True)
    _, row1, row2_server, row1_server = out["port"]
    np.testing.assert_allclose(row1, mirror[1] - 0.1, rtol=RTOL)
    np.testing.assert_allclose(row2_server, mirror[2] - 0.1, rtol=RTOL)
    np.testing.assert_array_equal(row1_server, row1)
    for a, b in zip(out["port"][1:], out["ref"][1:]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)


def test_free_target_tracks_latency_and_miss_pressure():
    def run(side):
        cache = side.cache
        cache.watermark_min_frac, cache.watermark_max_frac = 0.0, 0.2
        out = [cache.free_target()]
        for pull_ms, hit, miss in ((0.05, 50.0, 50.0), (50.0, 50.0, 50.0),
                                   (50.0, 100.0, 0.0), (1.0, 90.0, 10.0)):
            cache._pull_ms_ema = pull_ms
            cache._hit_ema, cache._miss_ema = hit, miss
            out.append(cache.free_target())
        return out

    out = _pair(run, 100)
    assert out["port"] == out["ref"]
    assert out["port"][:4] == [0, 0, 20, 0] and 0 < out["port"][4] <= 20


def test_evict_ahead_frees_dirty_rows_through_the_write_back():
    mirror = deterministic_init(1000, np.arange(16, dtype=np.uint64), DIM,
                                0.1)

    def run(side):
        wb = side.pkg.WriteBackQueue(side.cli)
        kw = {"device": "cpu"} if side.pkg is ps else {}
        cache = side.pkg.HbmEmbeddingCache(side.cli, 1000, DIM, 17,
                                           optimizer="sgd", lr=0.1,
                                           writeback=wb,
                                           watermark=(0.0, 0.5), **kw)
        side.cache = cache
        try:
            side.train(np.arange(16, dtype=np.int64).reshape(1, 16))
            cache._pull_ms_ema = 50.0
            cache._hit_ema, cache._miss_ema = 50.0, 50.0
            target = cache.free_target()
            freed = cache.evict_ahead()
            wb.flush()
            evicted = [k for k in range(16) if k not in cache._slots]
            rows = side.cli.pull_sparse(1000, np.asarray(evicted, np.uint64))
            cache._pull_ms_ema = 0.01
            lazy = cache.evict_ahead()
            return (target, freed, evicted, lazy), rows
        finally:
            wb.stop(flush=False)

    out = _pair(run, 17)
    assert out["port"][0] == out["ref"][0]
    (target, freed, evicted, lazy), rows = out["port"]
    assert target == 8 and freed == 8 and len(evicted) == 8 and lazy == 0
    np.testing.assert_allclose(rows, mirror[evicted] - 0.1, rtol=RTOL)
    np.testing.assert_allclose(rows, out["ref"][1], rtol=RTOL, atol=1e-7)


# -- the CTR pipeline --------------------------------------------------------

K, NB, BATCH, SLOTS, VOCAB, EDIM = 4, 16, 64, 4, 2000, 8


def _ctr_tables(pkg):
    return [pkg.TableConfig(1000, "sparse", EDIM, "sgd", lr=0.05,
                            init_range=0.05, seed=1000),
            pkg.TableConfig(1001, "sparse", 1, "sgd", lr=0.05,
                            init_range=0.05, seed=1001)]


def _ref_dense_state():
    ref_reset()
    paddle.seed(0)
    m = ref_ctr.WideAndDeep(VOCAB, dim=EDIM, slots=SLOTS, hidden=(16,),
                            cached=False)
    state = {k: np.asarray(v) for k, v in m.state_dict().items()}
    ref_reset()
    return state


def _batches():
    return ctr.synthetic_ctr_batches(NB, batch_size=BATCH, slots=SLOTS,
                                     vocab=VOCAB, seed=3)


def _port_windows(state, prefetch, cached=True, capacity=1 << 10,
                  watermark=(0.0, 0.15)):
    reset_registry()
    srv = ps.PsServer(_ctr_tables(ps), port=0)
    cli = ps.PsClient([f"127.0.0.1:{srv.start()}"])
    wb = ps.WriteBackQueue(cli) if cached else None
    try:
        model = ctr.WideAndDeep(VOCAB, dim=EDIM, slots=SLOTS, hidden=(16,),
                                cached=cached, capacity=capacity,
                                optimizer="sgd", lr=0.05, writeback=wb,
                                watermark=watermark, device="cpu")
        bridge.load_reference_state(model, state)
        comm = SyncCommunicator(cli, n_workers=1)
        ps.bind_model(model, comm)
        opt = pt.optimizer.Adam(parameters=model.parameters(),
                                learning_rate=0.001)
        if cached:
            r = ctr.train_ctr_windows(model, opt, _batches(), k=K,
                                      prefetch=prefetch, flush=True)
            losses = np.asarray(r["losses"])
        else:
            r, losses = {}, _uncached_windows(model, comm, opt, cli)
        rows = [cli.pull_sparse(t, np.arange(VOCAB, dtype=np.uint64))
                for t in (1000, 1001)]
        dense = [p.detach().numpy().copy() for p in model.parameters()]
        return losses, r, rows, dense
    finally:
        if wb is not None:
            wb.stop(flush=False)
        cli.stop_servers()
        cli.close()
        srv.stop()


def _uncached_windows(model, comm, opt, cli):
    """The uncached PS path with the window structure the k-step pipeline
    trains under: per-batch pulls see the rows as of the last window
    boundary, sparse gradients push once a window (SGD is linear)."""
    losses = []
    batches = _batches()
    for w in range(NB // K):
        for i in range(K):
            ids, label = batches[w * K + i]
            loss = F.binary_cross_entropy_with_logits(
                model(torch.from_numpy(ids)), torch.from_numpy(label))
            loss.backward()
            flush_sparse_grads(comm)
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        for table_id, keys, grads in comm._sparse_push:
            cli.push_sparse_grad(table_id, keys, grads)
        comm._sparse_push.clear()
    return np.asarray(losses)


def _ref_windows(state):
    ref_reset()
    srv = ref_ps.PsServer(_ctr_tables(ref_ps), port=0)
    cli = ref_ps.PsClient([f"127.0.0.1:{srv.start()}"])
    try:
        model = ref_ctr.WideAndDeep(VOCAB, dim=EDIM, slots=SLOTS,
                                    hidden=(16,), cached=True,
                                    capacity=1 << 10, optimizer="sgd",
                                    lr=0.05)
        model.set_state_dict(state)
        comm = RefSync(cli, n_workers=1)
        ref_ps.bind_model(model, comm)
        opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                    learning_rate=0.001)
        r = ref_ctr.train_ctr_windows(model, opt, _batches(), k=K,
                                      prefetch=False, flush=True)
        return np.asarray(r["losses"])
    finally:
        cli.stop_servers()
        cli.close()
        srv.stop()


def test_prefetch_on_equals_off_bitwise_and_learns():
    state = _ref_dense_state()
    on, r_on, rows_on, dense_on = _port_windows(state, True)
    off, r_off, rows_off, dense_off = _port_windows(state, False)
    np.testing.assert_array_equal(on, off)
    for a, b in zip(rows_on + dense_on, rows_off + dense_off):
        np.testing.assert_array_equal(a, b)
    assert np.mean(on[-K:]) < np.mean(on[:K])
    assert r_off["overlap_efficiency"] == 0.0
    assert 0.0 <= r_on["overlap_efficiency"] <= 1.0
    assert r_on["lookups"] == NB * BATCH * SLOTS * 2


# A cache below the run's working set: 646 distinct ids a table against
# 599 rows, while the union of any three consecutive windows (the one in
# flight and the two planned ahead, all pinned) is at most 540 ids. No rows
# are kept free ahead, so every eviction is the planner's, deferred.
EVICTING = dict(capacity=600, watermark=(0.0, 0.0))


def test_prefetch_on_equals_off_bitwise_through_evictions():
    """With a cache that evicts, the two runs still agree bitwise, and the
    server's rows after the flush are those of a cache that never
    evicts."""
    state = _ref_dense_state()
    runs = {}
    for prefetch in (True, False):
        before = monitor.stat_get("hbm_cache_deferred_evict")
        runs[prefetch] = _port_windows(state, prefetch, **EVICTING)
        assert monitor.stat_get("hbm_cache_deferred_evict") > before
    (on, _, rows_on, dense_on), (off, _, rows_off, dense_off) = \
        runs[True], runs[False]
    np.testing.assert_array_equal(on, off)
    for a, b in zip(rows_on + dense_on, rows_off + dense_off):
        np.testing.assert_array_equal(a, b)
    roomy, _, rows_roomy, _ = _port_windows(state, False)
    np.testing.assert_array_equal(on, roomy)
    for a, b in zip(rows_on, rows_roomy):
        np.testing.assert_array_equal(a, b)


def test_the_prefetcher_thread_touches_no_device_tensor(monkeypatch):
    """Every tensor made or written while the pipeline runs is made or
    written on the consumer thread: the planner stages pulled rows on the
    host and defers its evictions' write-backs, and the delta store exists
    from the cache's construction."""
    threads = set()

    def on_caller(owner, name):
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            threads.add((name, threading.get_ident()))
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, wrapped)

    for name in ("zeros", "zeros_like", "empty", "ones_like", "from_numpy",
                 "as_tensor", "tensor"):
        on_caller(torch, name)
    for name in ("index_copy_", "index_add_", "index_select", "copy_",
                 "zero_", "to"):
        on_caller(torch.Tensor, name)
    before = monitor.stat_get("hbm_cache_deferred_evict")
    _port_windows(_ref_dense_state(), True, **EVICTING)
    assert monitor.stat_get("hbm_cache_deferred_evict") > before
    assert threads and {t for _, t in threads} == {threading.get_ident()}


def test_cached_pipeline_matches_the_uncached_path_and_the_reference():
    state = _ref_dense_state()
    cached, _, rows, _ = _port_windows(state, False)
    uncached, _, rows_u, _ = _port_windows(state, False, cached=False)
    np.testing.assert_allclose(cached, uncached, atol=UNCACHED_ATOL)
    for a, b in zip(rows, rows_u):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(cached, _ref_windows(state), rtol=REF_RTOL)
