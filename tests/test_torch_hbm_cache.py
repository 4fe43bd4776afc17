"""The port's device-resident embedding cache against the reference's, on
the CPU: every case of ``tests/test_hbm_cache.py`` but the 8-device mesh
one (row sharding waits), each run through both packages' caches on the
same ids, each cache against its own package's server.

- The host index (slots, LRU order, free list, dirty rows, counters) is
  equal to the reference's exactly; device rows within ``RTOL`` (float32
  gathers and updates in another library's order), the server rows after
  ``end_pass`` equal to the port's device rows exactly.
- Losses of the cached model against the direct PS path within
  ``LOSS_RTOL`` (the reference's own bound), and against the reference's
  cached model (per batch, and two ``PsTpuTrainer`` passes with a warm
  cache) within ``LOSS_RTOL`` with dense weights carried across.
- The fused pass (one ``to_static(body, scan_steps=K)`` program) against
  the eager lookup/apply path within ``RTOL``, and bitwise against the
  same body run eagerly batch by batch.
"""
import gc

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
import paddle_tpu_torch as pt
from paddle_tpu_torch import bridge, monitor
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps.communicator import SyncCommunicator
from paddle_tpu_torch.distributed.ps.embedding import (deterministic_init,
                                                       flush_sparse_grads,
                                                       reset_registry)
from paddle_tpu_torch.nn import functional as F

VOCAB, DIM = 50, 4
RTOL, ATOL = 1e-5, 1e-7
LOSS_RTOL = 2e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)
    yield
    # the registries hold the embedding layers, and through their
    # communicators the dense parameters: drop them, so no later test
    # of this process sees them in the state ledger
    reset_registry()
    ref_reset()
    gc.collect()


def _stats_reset():
    for mon in (monitor, ref_monitor):
        for k in ("hit", "miss", "evict", "staged", "writeback_rows"):
            mon.stat_reset(f"hbm_cache_{k}")


class _Side:
    """One package's server, client and cache(s)."""

    def __init__(self, pkg, tables, caches):
        self.srv = pkg.PsServer(tables, port=0)
        port = self.srv.start()
        self.cli = pkg.PsClient([f"127.0.0.1:{port}"])
        for t in tables:
            if t.kind == "sparse":
                self.cli.register_sparse(t.table_id, t.dim)
        kw = {"device": "cpu"} if pkg is ps else {}
        self.caches = [pkg.HbmEmbeddingCache(self.cli, tid, DIM, cap, **c,
                                             **kw)
                       for tid, cap, c in caches]

    def close(self):
        self.cli.stop_servers()
        self.cli.close()
        self.srv.stop()


class _Pair:
    """The same tables and caches in both packages."""

    def __init__(self, tables, caches):
        self.ref = _Side(ref_ps, tables(ref_ps), caches)
        self.port = _Side(ps, tables(ps), caches)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ref.close()
        self.port.close()

    def lookup(self, ids, i=0, backward=None):
        """``lookup(ids)`` on both caches; with ``backward`` ("sum" or a
        cotangent array) the gradient is taken and applied."""
        ro = self.ref.caches[i].lookup(paddle.to_tensor(ids))
        po = self.port.caches[i].lookup(torch.from_numpy(ids))
        np.testing.assert_allclose(po.detach().numpy(), np.asarray(ro.numpy()),
                                   rtol=RTOL, atol=ATOL)
        if backward is not None:
            if isinstance(backward, str):
                paddle.ops.sum(ro).backward()
                po.sum().backward()
            else:
                paddle.ops.sum(ro * paddle.to_tensor(backward)).backward()
                (po * torch.from_numpy(backward)).sum().backward()
            self.ref.caches[i].apply_grads()
            self.port.caches[i].apply_grads()
        return ro, po

    def check(self, i=0):
        rc, pc = self.ref.caches[i], self.port.caches[i]
        assert list(pc._slots.items()) == list(rc._slots.items())
        assert pc._free == rc._free
        np.testing.assert_array_equal(pc._dirty, rc._dirty)
        slots = list(pc._slots.values())
        np.testing.assert_allclose(pc.table.numpy()[slots],
                                   np.asarray(rc.table)[slots], rtol=RTOL,
                                   atol=ATOL)


def _sgd_tables(pkg):
    return [pkg.TableConfig(1000, "sparse", DIM, "sgd", lr=0.1,
                            init_range=0.1, seed=1000)]


def _sgd_pair(capacity):
    return _Pair(_sgd_tables, [(1000, capacity,
                                dict(optimizer="sgd", lr=0.1))])


def test_lookup_update_writeback_matches_numpy_and_the_reference():
    _stats_reset()
    with _sgd_pair(16) as p:
        ids = np.array([[3, 7, 3], [9, 7, 11]], np.int64)
        mirror = deterministic_init(
            1000, np.arange(VOCAB, dtype=np.uint64), DIM, 0.1)
        _, out = p.lookup(ids, backward="sum")
        np.testing.assert_allclose(out.detach().numpy(), mirror[ids],
                                   rtol=RTOL, atol=ATOL)
        cache = p.port.caches[0]
        # duplicate ids accumulate into one row update
        for k in (3, 7, 9, 11):
            dup = 2 if k in (3, 7) else 1
            np.testing.assert_allclose(cache.table[cache._slots[k]].numpy(),
                                       mirror[k] - 0.1 * dup, rtol=RTOL)
        p.check()
        for side in (p.ref, p.port):
            side.caches[0].end_pass()
        keys = np.array([3, 7, 9, 11], np.uint64)
        got = p.port.cli.pull_sparse(1000, keys)
        np.testing.assert_array_equal(
            got, cache.table.numpy()[[cache._slots[int(k)] for k in keys]])
        np.testing.assert_allclose(got, p.ref.cli.pull_sparse(1000, keys),
                                   rtol=RTOL, atol=ATOL)
        s = cache.stats
        assert s["miss"] == 4 and s["writeback_rows"] == 4


def test_lru_eviction_writes_back_and_refaults():
    _stats_reset()
    # capacity 5 = scratch + 4 rows; 6 keys force the LRU keys out
    with _sgd_pair(5) as p:
        p.lookup(np.array([[1, 2, 3, 4]], np.int64), backward="sum")
        p.lookup(np.array([[5, 6]], np.int64))
        cache = p.port.caches[0]
        assert cache.stats["evict"] == 2
        assert 1 not in cache._slots and 2 not in cache._slots
        p.check()
        mirror = deterministic_init(
            1000, np.arange(VOCAB, dtype=np.uint64), DIM, 0.1)
        got = p.port.cli.pull_sparse(1000, np.array([1, 2], np.uint64))
        np.testing.assert_allclose(got, mirror[[1, 2]] - 0.1, rtol=RTOL)
        # a re-faulted key returns its trained value
        _, out = p.lookup(np.array([[1]], np.int64))
        np.testing.assert_allclose(out.detach().numpy()[0, 0],
                                   mirror[1] - 0.1, rtol=RTOL)
        p.check()


def test_lru_refresh_ordering():
    _stats_reset()
    with _sgd_pair(5) as p:
        p.lookup(np.array([[1, 2, 3, 4]], np.int64), backward="sum")
        p.lookup(np.array([[1]], np.int64), backward="sum")
        p.lookup(np.array([[5, 6]], np.int64))
        cache = p.port.caches[0]
        assert cache.stats["evict"] == 2
        assert 1 in cache._slots and 4 in cache._slots
        assert 2 not in cache._slots and 3 not in cache._slots
        p.check()


def test_pending_slots_are_never_evicted():
    with _sgd_pair(5) as p:
        p.lookup(np.array([[1, 2, 3, 4]], np.int64))
        for side, to in ((p.ref, paddle.to_tensor),
                         (p.port, torch.from_numpy)):
            with pytest.raises(RuntimeError, match="un-applied"):
                side.caches[0].lookup(to(np.array([[5, 6]], np.int64)))
        p.check()


def test_an_over_capacity_batch_fails_loudly():
    with _sgd_pair(3) as p:
        for side, to in ((p.ref, paddle.to_tensor),
                         (p.port, torch.from_numpy)):
            with pytest.raises(RuntimeError, match="capacity"):
                side.caches[0].lookup(to(np.array([[1, 2, 3, 4, 5]],
                                                  np.int64)))


def test_adam_cache_matches_the_servers_adam():
    def tables(pkg):
        return [pkg.TableConfig(t, "sparse", DIM, "adam", lr=0.05,
                                init_range=0.1, seed=1000)
                for t in (1000, 1001)]

    with _Pair(tables, [(1001, 16, dict(optimizer="adam", lr=0.05))]) as p:
        keys = np.array([2, 5, 9], np.uint64)
        rng = np.random.RandomState(0)
        for _ in range(4):
            g = rng.randn(3, DIM).astype(np.float32)
            p.port.cli.push_sparse_grad(1000, keys, g)  # the server's Adam
            p.lookup(keys.astype(np.int64)[None, :], backward=g[None])
        cache = p.port.caches[0]
        want = p.port.cli.pull_sparse(1000, keys)
        slots = [cache._slots[int(k)] for k in keys]
        np.testing.assert_allclose(cache.table.numpy()[slots], want,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(cache.t.numpy()[slots], 4.0)
        p.check()


def _make_ctr(pkg, embed_cls, **emb_kw):
    class Ctr(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = embed_cls([VOCAB, DIM], init_range=0.1, **emb_kw)
            kw = {"device": "cpu"} if pkg is not paddle else {}
            self.fc = pkg.nn.Linear(3 * DIM, 1, **kw)

        def forward(self, ids):
            e = self.emb(ids)
            return self.fc(e.reshape([e.shape[0], 3 * DIM]))

    return Ctr()


def _batches(n, seed=7):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(1).randn(VOCAB).astype(np.float32)
    out = []
    for _ in range(n):
        ids = rng.randint(0, VOCAB, (16, 3)).astype(np.int64)
        label = (w[ids[:, 0]] > 0).astype(np.float32).reshape(-1, 1)
        out.append((ids, label))
    return out


def _ctr_tables(pkg):
    return [pkg.TableConfig(1000, "sparse", DIM, "sgd", lr=0.1,
                            init_range=0.1, seed=1000),
            pkg.TableConfig(0, "dense", 0, "sgd", lr=0.1),
            pkg.TableConfig(1, "dense", 0, "sgd", lr=0.1)]


def _fc_init():
    paddle.seed(0)
    return {k: np.asarray(v) for k, v in
            _make_ctr(paddle, ref_ps.SparseEmbedding,
                      table_id=1000).fc.state_dict().items()}


def _port_run(cached, steps, init):
    reset_registry()
    srv = ps.PsServer(_ctr_tables(ps), port=0)
    cli = ps.PsClient([f"127.0.0.1:{srv.start()}"])
    try:
        if cached:
            model = _make_ctr(pt, ps.CachedSparseEmbedding, capacity=56,
                              optimizer="sgd", lr=0.1, table_id=1000,
                              device="cpu")
        else:
            model = _make_ctr(pt, ps.SparseEmbedding, table_id=1000)
        bridge.load_reference_state(model.fc, init)
        comm = SyncCommunicator(cli, n_workers=1)
        ps.bind_model(model, comm)
        comm.init_params()
        losses = []
        for ids, label in _batches(steps):
            loss = F.binary_cross_entropy_with_logits(
                model(torch.from_numpy(ids)), torch.from_numpy(label))
            loss.backward()
            if cached:
                model.emb.cache.apply_grads()
            flush_sparse_grads(comm)
            comm.step()
            losses.append(float(loss.detach()))
        if cached:
            model.emb.cache.end_pass()
        return np.asarray(losses)
    finally:
        cli.stop_servers()
        cli.close()
        srv.stop()


def _ref_cached_run(steps, init):
    from paddle_tpu.distributed.ps.embedding import flush_sparse_grads as fl
    ref_reset()
    srv = ref_ps.PsServer(_ctr_tables(ref_ps), port=0)
    cli = ref_ps.PsClient([f"127.0.0.1:{srv.start()}"])
    try:
        model = _make_ctr(paddle, ref_ps.CachedSparseEmbedding, capacity=56,
                          optimizer="sgd", lr=0.1, table_id=1000)
        model.fc.set_state_dict(init)
        comm = RefSync(cli, n_workers=1)
        ref_ps.bind_model(model, comm)
        comm.init_params()
        losses = []
        for ids, label in _batches(steps):
            loss = paddle.nn.functional.binary_cross_entropy_with_logits(
                model(paddle.to_tensor(ids)), paddle.to_tensor(label))
            loss.backward()
            model.emb.cache.apply_grads()
            fl(comm)
            comm.step()
            losses.append(float(loss.numpy()))
        return np.asarray(losses)
    finally:
        cli.stop_servers()
        cli.close()
        srv.stop()


def test_cached_training_matches_the_direct_ps_path_and_the_reference():
    init = _fc_init()
    direct = _port_run(False, 30, init)
    cached = _port_run(True, 30, init)
    np.testing.assert_allclose(cached, direct, rtol=LOSS_RTOL)
    assert np.mean(direct[-5:]) < np.mean(direct[:5])
    np.testing.assert_allclose(cached[:10], _ref_cached_run(10, init),
                               rtol=LOSS_RTOL)


def _fused_tables(pkg):
    return [pkg.TableConfig(1000, "sparse", DIM, "sgd", lr=0.05,
                            init_range=0.1, seed=1000)]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fused_pass_matches_eager_and_the_reference(optimizer):
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    batches = [rng.randint(0, 20, (4, 3)).astype(np.int64)
               for _ in range(6)]
    all_keys = np.concatenate([b.ravel() for b in batches])
    kw = dict(optimizer=optimizer, lr=0.05)
    with _Pair(_fused_tables, [(1000, 32, kw), (1000, 32, kw),
                               (1000, 32, kw)]) as p:
        eager, fused, twin = p.port.caches
        for c in p.port.caches + p.ref.caches[:1]:
            c.build_pass(all_keys)
        eager_losses = []
        for ids in batches:
            out = eager.lookup(torch.from_numpy(ids))
            loss = (out * out).sum()
            loss.backward()
            eager.apply_grads()
            eager_losses.append(float(loss.detach()))

        def sq(e):
            return (e * e).sum()

        fused_losses = fused.run_fused_pass(batches, sq)
        np.testing.assert_allclose(fused_losses, eager_losses, rtol=RTOL)
        # the program is bitwise the same body run eagerly
        np.testing.assert_array_equal(
            twin._fused_pass(batches, sq, None, program=False), fused_losses)
        np.testing.assert_array_equal(twin.table.numpy(), fused.table.numpy())
        ref_losses = p.ref.caches[0].run_fused_pass(
            batches, lambda e: jnp.sum(e * e))
        np.testing.assert_allclose(fused_losses, ref_losses, rtol=RTOL)
        for k in np.unique(all_keys):
            np.testing.assert_allclose(
                fused.table[fused._slots[int(k)]].numpy(),
                eager.table[eager._slots[int(k)]].numpy(), rtol=RTOL,
                atol=ATOL)
            np.testing.assert_allclose(
                fused.table[fused._slots[int(k)]].numpy(),
                np.asarray(p.ref.caches[0].table)[
                    p.ref.caches[0]._slots[int(k)]], rtol=RTOL, atol=ATOL)
        # a second pass reuses the program
        assert len(fused._fused_progs) == 1
        fused.run_fused_pass(batches, sq)
        assert len(fused._fused_progs) == 1


def test_fused_pass_requires_staging():
    with _Pair(_fused_tables, [(1000, 32, dict(optimizer="sgd"))]) as p:
        with pytest.raises(RuntimeError, match="staged"):
            p.port.caches[0].run_fused_pass(
                [np.array([[1, 2]], np.int64)], lambda e: e.sum())


def test_mesh_row_sharding_raises_by_name():
    with pytest.raises(NotImplementedError, match="mesh"):
        ps.HbmEmbeddingCache(None, 1000, DIM, 16, mesh=object(),
                             mesh_axis="mp", device="cpu")


def _ref_two_passes(init, keys):
    """The reference's PsTpuTrainer over the same two passes: both passes'
    losses and the server's rows of ``keys`` afterwards."""
    ref_reset()
    srv = ref_ps.PsServer(_ctr_tables(ref_ps), port=0)
    cli = ref_ps.PsClient([f"127.0.0.1:{srv.start()}"])
    try:
        model = _make_ctr(paddle, ref_ps.CachedSparseEmbedding, capacity=56,
                          optimizer="sgd", lr=0.1, table_id=1000)
        model.fc.set_state_dict(init)
        comm = RefSync(cli, n_workers=1)
        ref_ps.bind_model(model, comm)
        comm.init_params()

        def loss_fn(m, batch):
            ids, label = batch
            return paddle.nn.functional.binary_cross_entropy_with_logits(
                m(paddle.to_tensor(ids)), paddle.to_tensor(label))

        trainer = ref_ps.PsTpuTrainer(model, loss_fn, comm)
        losses = [trainer.train_pass(_batches(10))["losses"]
                  for _ in range(2)]
        return losses, cli.pull_sparse(1000, keys)
    finally:
        cli.stop_servers()
        cli.close()
        srv.stop()


def test_two_passes_with_a_warm_cache():
    _stats_reset()
    reset_registry()
    init = _fc_init()
    srv = ps.PsServer(_ctr_tables(ps), port=0)
    cli = ps.PsClient([f"127.0.0.1:{srv.start()}"])
    try:
        model = _make_ctr(pt, ps.CachedSparseEmbedding, capacity=56,
                          optimizer="sgd", lr=0.1, table_id=1000,
                          device="cpu")
        bridge.load_reference_state(model.fc, init)
        comm = SyncCommunicator(cli, n_workers=1)
        ps.bind_model(model, comm)
        comm.init_params()

        def loss_fn(m, batch):
            ids, label = batch
            return F.binary_cross_entropy_with_logits(
                m(torch.from_numpy(ids)), torch.from_numpy(label))

        trainer = ps.PsTpuTrainer(model, loss_fn, comm)
        r1 = trainer.train_pass(_batches(10))
        assert r1["batches"] == 10
        monitor.stat_reset("hbm_cache_miss")
        r2 = trainer.train_pass(_batches(10))
        cache = trainer.caches[0]
        assert cache.stats["miss"] == 0 and cache.stats["hit"] > 0
        assert np.mean(r2["losses"]) < np.mean(r1["losses"])
        keys = np.fromiter(cache._slots, np.uint64)
        rows = cli.pull_sparse(1000, keys)
        np.testing.assert_array_equal(
            rows, cache.table.numpy()[list(cache._slots.values())])
    finally:
        cli.stop_servers()
        cli.close()
        srv.stop()
    ref_losses, ref_rows = _ref_two_passes(init, keys)
    np.testing.assert_allclose(r1["losses"] + r2["losses"],
                               ref_losses[0] + ref_losses[1],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(rows, ref_rows, rtol=RTOL, atol=ATOL)
