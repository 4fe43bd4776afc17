"""The port's graph PS client against the reference's, on the CPU
(``tests/test_graph_ps.py``'s in-process cases through the port, and the
two packages crossed).

- The port's client against the port's server: the node, edge and feature
  round trip, the sampler against :func:`deterministic_sample_indices`
  bit for bit, pull list, random nodes, walks, k-hop expansion and the
  snapshot round trip; and against two server processes, the nodes
  sharded by id.
- Each package's client against the other package's server (one server of
  each package at a time, port 0): the same bytes on the wire, so the same
  samples, features, lists and counts, exactly.
- The GraphSAGE loop of ``tests/test_graph_ps.py``, each package through
  its own server, from the same weights (moved over by ``bridge``): losses
  within ``LOSS_RTOL`` (the same float32 math in another library).
"""
import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import ps as ref_ps
import paddle_tpu_torch as pt
from paddle_tpu_torch import bridge
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps.graph import (
    _decode_samples, deterministic_sample_indices)
from paddle_tpu_torch.nn import functional as F

FEAT = 8
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _release():
    yield
    # the layers a test built may sit in reference cycles: collect them,
    # so no later test of this process finds them in the state ledger
    gc.collect()


class _Graph:
    """A server of ``srv_pkg`` with graph table 7 and a client of
    ``cli_pkg``."""

    def __init__(self, srv_pkg=ps, cli_pkg=ps, n_feat=FEAT):
        self.srv = srv_pkg.PsServer([srv_pkg.TableConfig(7, "graph", n_feat)],
                                    port=0)
        self.endpoint = f"127.0.0.1:{self.srv.start()}"
        self.cli = cli_pkg.PsClient([self.endpoint])
        self.g = cli_pkg.GraphPsClient(self.cli, 7, n_feat)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cli.stop_servers()
        self.cli.close()
        self.srv.stop()


def test_nodes_edges_feat_roundtrip():
    with _Graph() as s:
        g = s.g
        ids = np.arange(10, dtype=np.uint64)
        feats = np.random.RandomState(0).randn(10, FEAT).astype(np.float32)
        g.add_nodes(ids, feats)
        g.add_edges([0, 0, 1, 2], [1, 2, 3, 0])
        np.testing.assert_array_equal(g.node_feat(ids), feats)
        assert g.node_count() == 10
        np.testing.assert_array_equal(g.node_feat(np.array([99], np.uint64)),
                                      np.zeros((1, FEAT)))
        nbrs, w, cnt = g.sample_neighbors(np.array([99, 0, 3], np.uint64), 3)
        assert cnt.tolist() == [0, 2, 0]
        assert sorted(nbrs[1, :2].tolist()) == [1, 2] and nbrs[1, 2] == 0
        np.testing.assert_array_equal(nbrs[[0, 2]], [[99] * 3, [3] * 3])
        assert w[1].tolist() == [1.0, 1.0, 0.0]


def test_sampling_matches_the_python_mirror():
    with _Graph() as s:
        g = s.g
        nbrs_of_5 = np.array([10, 11, 12, 13, 14, 15, 16], np.uint64)
        g.add_nodes(np.array([5], np.uint64))
        g.add_edges(np.full(7, 5, np.uint64), nbrs_of_5,
                    np.arange(7, dtype=np.float32))
        for seed in (0, 1, 12345):
            nbrs, w, cnt = g.sample_neighbors(np.array([5], np.uint64), 3,
                                              seed=seed)
            want = deterministic_sample_indices(seed, 5, 7, 3)
            np.testing.assert_array_equal(nbrs[0], nbrs_of_5[want])
            np.testing.assert_array_equal(
                w[0], np.arange(7, dtype=np.float32)[want])
            assert cnt[0] == 3
        nbrs, _, cnt = g.sample_neighbors(np.array([5], np.uint64), 99,
                                          seed=3)
        assert cnt[0] == 7
        assert set(nbrs[0, :7].tolist()) == set(nbrs_of_5.tolist())


def test_a_ragged_reply_decodes_like_the_reference_loop():
    """Counts 0..k, decoded by numpy views, against the reference's entry
    by entry loop."""
    r = np.random.RandomState(4)
    k, counts = 5, r.randint(0, 6, 40)
    raw = b"".join(
        np.uint32(c).tobytes() + b"".join(
            np.uint64(r.randint(0, 1 << 62)).tobytes()
            + np.float32(r.randn()).tobytes() for _ in range(c))
        for c in counts)
    got_c, nb, wt, filled = _decode_samples(raw, counts.size, k)
    np.testing.assert_array_equal(got_c, counts)
    off, want_nb, want_wt = 0, [], []
    for c in counts:
        off += 4
        for _ in range(c):
            want_nb.append(np.frombuffer(raw, np.uint64, 1, off)[0])
            want_wt.append(np.frombuffer(raw, np.float32, 1, off + 8)[0])
            off += 12
    np.testing.assert_array_equal(nb, want_nb)
    np.testing.assert_array_equal(wt, want_wt)
    assert filled.sum() == counts.sum()


def test_pull_list_random_nodes_walks_and_khop():
    with _Graph() as s:
        g = s.g
        ids = np.arange(20, dtype=np.uint64)
        g.add_nodes(ids)
        g.add_edges(ids, (ids + 1) % 20)   # ring graph: i -> i+1
        np.testing.assert_array_equal(g.pull_graph_list(0, 0, 7), ids[:7])
        np.testing.assert_array_equal(g.pull_graph_list(0, 15, 99),
                                      ids[15:])
        r1 = g.random_sample_nodes(0, 5, seed=9)
        np.testing.assert_array_equal(r1, g.random_sample_nodes(0, 5, seed=9))
        assert len(set(r1.tolist())) == 5
        walks = g.random_walk(np.array([0, 5], np.uint64), 4, seed=1)
        np.testing.assert_array_equal(walks[0], [0, 1, 2, 3, 4])
        np.testing.assert_array_equal(walks[1], [5, 6, 7, 8, 9])
        hops = g.sample_khop(np.array([1, 2], np.uint64), [3, 2], seed=5)
        assert [h[0].shape for h in hops] == [(2, 3), (6, 2)]
        np.testing.assert_array_equal(hops[0][0][:, 0], [2, 3])


def test_snapshot_roundtrip_preserves_the_graph(tmp_path):
    snap = str(tmp_path / "graph_snap")
    ids = np.arange(12, dtype=np.uint64)
    feats = np.random.RandomState(3).randn(12, FEAT).astype(np.float32)
    with _Graph() as s:
        s.g.add_nodes(ids, feats)
        s.g.add_edges(ids, (ids + 3) % 12)
        before = s.g.sample_neighbors(ids, 2, seed=4)
        s.cli.save(snap)
    with _Graph() as s:
        s.cli.load(snap)
        assert s.g.node_count() == 12
        np.testing.assert_array_equal(s.g.node_feat(ids), feats)
        for a, b in zip(before, s.g.sample_neighbors(ids, 2, seed=4)):
            np.testing.assert_array_equal(a, b)


_SERVER_SCRIPT = f"""
from paddle_tpu_torch.distributed.ps import PsServer, TableConfig
srv = PsServer([TableConfig(7, "graph", {FEAT})], port=0)
print("SERVER_READY", srv.start(), flush=True)
srv.run()
"""


def test_two_server_processes_shard_the_graph():
    """Nodes shard by ``id % 2`` over two server processes (the
    reference's cluster test through the port): per-shard lists, features,
    the sampler against its mirror, k-hop expansion."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          .parent))
    procs = [subprocess.Popen([sys.executable, "-c", _SERVER_SCRIPT],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    cli = None
    try:
        lines = [p.stdout.readline() for p in procs]
        assert all(ln.startswith("SERVER_READY") for ln in lines), \
            lines + [p.stderr.read()[-2000:] for p in procs]
        cli = ps.PsClient([f"127.0.0.1:{ln.split()[1]}" for ln in lines])
        g = ps.GraphPsClient(cli, 7, FEAT)
        r = np.random.RandomState(0)
        ids = np.arange(40, dtype=np.uint64)
        feats = r.randn(40, FEAT).astype(np.float32)
        g.add_nodes(ids, feats)
        src = r.randint(0, 40, 300).astype(np.uint64)
        dst = r.randint(0, 40, 300).astype(np.uint64)
        g.add_edges(src, dst)
        assert g.node_count() == 40
        assert set(g.pull_graph_list(0, 0, 99).tolist()) == set(range(0, 40,
                                                                      2))
        assert set(g.pull_graph_list(1, 0, 99).tolist()) == set(range(1, 40,
                                                                      2))
        np.testing.assert_array_equal(g.node_feat(ids[::-1]), feats[::-1])
        nbrs, _w, cnt = g.sample_neighbors(ids, 4, seed=3)
        for v in range(40):
            adj = dst[src == v]
            want = adj[deterministic_sample_indices(3, v, adj.size, 4)]
            assert cnt[v] == want.size
            np.testing.assert_array_equal(nbrs[v, :want.size], want)
        hops = g.sample_khop(np.array([1, 2], np.uint64), [3, 2], seed=5)
        for a, b in zip(hops, g.sample_khop(np.array([1, 2], np.uint64),
                                            [3, 2], seed=5)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    finally:
        if cli is not None:
            cli.stop_servers()
            cli.close()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


@pytest.mark.parametrize("server", ["reference", "port"])
def test_each_client_against_the_other_packages_server(server):
    srv_pkg = ref_ps if server == "reference" else ps
    r = np.random.RandomState(0)
    ids = np.arange(40, dtype=np.uint64)
    feats = r.randn(40, FEAT).astype(np.float32)
    src = r.randint(0, 40, 300).astype(np.uint64)
    dst = r.randint(0, 40, 300).astype(np.uint64)
    w = r.rand(300).astype(np.float32)
    with _Graph(srv_pkg, ps) as s:
        other = (ps if srv_pkg is ref_ps else ref_ps)
        ocli = other.PsClient([s.endpoint])
        og = other.GraphPsClient(ocli, 7, FEAT)
        # the other package's client builds the graph, the port's reads it
        og.add_nodes(ids[:20], feats[:20])
        s.g.add_nodes(ids[20:], feats[20:])
        og.add_edges(src[:150], dst[:150], w[:150])
        s.g.add_edges(src[150:], dst[150:], w[150:])
        for g in (s.g, og):
            assert g.node_count() == 40
            np.testing.assert_array_equal(g.node_feat(ids), feats)
        q = np.array([3, 17, 39, 77, 3], np.uint64)
        for k, seed in ((1, 0), (4, 7), (50, 9)):
            for a, b in zip(s.g.sample_neighbors(q, k, seed),
                            og.sample_neighbors(q, k, seed)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(s.g.sample_khop(q, [5, 3], seed=2),
                        og.sample_khop(q, [5, 3], seed=2)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(s.g.pull_graph_list(0, 3, 10),
                                      og.pull_graph_list(0, 3, 10))
        np.testing.assert_array_equal(s.g.random_sample_nodes(0, 9, 4),
                                      og.random_sample_nodes(0, 9, 4))
        np.testing.assert_array_equal(s.g.random_walk(q, 5, seed=3),
                                      og.random_walk(q, 5, seed=3))
        ocli.close()


def _community_graph(g, rng):
    """``tests/test_graph_ps.py``'s two communities of 30 nodes."""
    n_per, comm = 30, 2
    ids = np.arange(n_per * comm, dtype=np.uint64)
    community = (ids >= n_per).astype(np.float32)
    feats = (rng.randn(ids.size, FEAT) * 1.5).astype(np.float32)
    feats[:, 0] += 2.0 * (community * 2 - 1)
    g.add_nodes(ids, feats)
    src, dst = [], []
    for c in range(comm):
        base = c * n_per
        for i in range(n_per):
            nbrs = rng.choice(n_per, 8, replace=False)
            src.extend([base + i] * 8)
            dst.extend((base + nbrs).tolist())
    g.add_edges(np.array(src, np.uint64), np.array(dst, np.uint64))
    return ids, community


def _ref_sage(steps):
    with _Graph(ref_ps, ref_ps) as s:
        rng = np.random.RandomState(0)
        ids, community = _community_graph(s.g, rng)

        class Sage(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = paddle.nn.Linear(2 * FEAT, 16)
                self.fc2 = paddle.nn.Linear(16, 1)

            def forward(self, self_f, nbr_f):
                h = paddle.ops.concat([self_f, nbr_f], axis=-1)
                return self.fc2(paddle.nn.functional.relu(self.fc1(h)))

        paddle.seed(0)
        model = Sage()
        init = {k: np.asarray(v.numpy()).copy()
                for k, v in model.state_dict().items()}
        opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                    learning_rate=0.01)
        losses = []
        for step in range(steps):
            batch = rng.choice(ids.size, 32, replace=False).astype(np.uint64)
            nbrs, _w, _c = s.g.sample_neighbors(batch, 5, seed=step)
            self_f = s.g.node_feat(batch)
            nbr_mean = s.g.node_feat(nbrs.ravel()).reshape(32, 5, FEAT) \
                .mean(axis=1)
            label = community[batch.astype(np.int64)].reshape(-1, 1)
            loss = paddle.nn.functional.binary_cross_entropy_with_logits(
                model(paddle.to_tensor(self_f), paddle.to_tensor(nbr_mean)),
                paddle.to_tensor(label))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
    return losses, init


def _port_sage(steps, init):
    with _Graph() as s:
        rng = np.random.RandomState(0)
        ids, community = _community_graph(s.g, rng)

        class Sage(pt.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = pt.nn.Linear(2 * FEAT, 16, device="cpu")
                self.fc2 = pt.nn.Linear(16, 1, device="cpu")

            def forward(self, self_f, nbr_f):
                h = torch.cat([self_f, nbr_f], dim=-1)
                return self.fc2(torch.relu(self.fc1(h)))

        model = bridge.load_reference_state(Sage(), init)
        opt = pt.optimizer.Adam(parameters=model.parameters(),
                                learning_rate=0.01)
        losses = []
        for step in range(steps):
            batch = rng.choice(ids.size, 32, replace=False).astype(np.uint64)
            nbrs, _w, _c = s.g.sample_neighbors(batch, 5, seed=step)
            self_f = s.g.node_feat(batch)
            nbr_mean = s.g.node_feat(nbrs.ravel()).reshape(32, 5, FEAT) \
                .mean(axis=1)
            label = community[batch.astype(np.int64)].reshape(-1, 1)
            loss = F.binary_cross_entropy_with_logits(
                model(torch.from_numpy(self_f), torch.from_numpy(nbr_mean)),
                torch.from_numpy(label))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
    return losses


def test_graphsage_loop_matches_the_reference():
    want, init = _ref_sage(60)
    got = _port_sage(60, init)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.mean(got[-10:]) < 0.25
    assert np.mean(got[-10:]) < np.mean(got[:10]) * 0.6
