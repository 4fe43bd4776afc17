"""The port's native PS service and its client against the reference's, on
the CPU (the cases of ``tests/test_parameter_server.py``'s table service
and ``tests/test_ssd_sparse_table.py``).

- Pulled rows equal ``deterministic_init`` (the Python mirror of the
  server's splitmix64 rule) within ``INIT_RTOL`` (the mirror computes in
  float64, the server in float32), the port's mirror equals the
  reference's bitwise, and ``server_init_rows`` (the rule in the server's
  float32 arithmetic) equals the pulled rows bitwise.
- Sparse SGD and Adam pushes against numpy within ``RULE_RTOL``; dense
  init, push, pull and deltas; save/load; the SSD spill (budgeted rows
  equal unbounded ones bitwise, through a snapshot too).
- A push retried across a server restart is applied exactly once.
- The wire across packages: the reference's ``PsClient`` against the
  port's ``PsServer`` and the port's client against the reference's
  server, each run of the same operations giving rows bitwise equal to
  the port's client against the port's server (one C++ source, one wire
  format).
- The build raises with the compiler's output (no fallback), and the
  package's import builds nothing.
- ``DownpourTrainer``: two threads over one client learn the reference
  test's task; the fleet's datasets and role makers give the reference's
  results on the same files and environments.

Each package holds one server a process (its own native library); a test
starts at most one of each.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import ps as ref_ps
from paddle_tpu.distributed.ps.embedding import \
    deterministic_init as ref_init
from paddle_tpu_torch import _native
from paddle_tpu_torch.distributed import ps
from paddle_tpu_torch.distributed.ps.embedding import (deterministic_init,
                                                       server_init_rows)
from paddle_tpu_torch.distributed.ps.retry import RetryPolicy

INIT_RTOL = 1e-6
RULE_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(pkg, tables, port=0):
    srv = pkg.PsServer(tables, port=port)
    port = srv.start()
    return srv, port


def _client(pkg, port, **kw):
    return pkg.PsClient([f"127.0.0.1:{port}"], **kw)


class _Server:
    """One package's server with one client of ``client_pkg``."""

    def __init__(self, pkg, tables, client_pkg=None):
        self.srv, self.port = _start(pkg, tables)
        self.cli = _client(client_pkg or pkg, self.port)

    def __enter__(self):
        return self.cli

    def __exit__(self, *exc):
        self.cli.stop_servers()
        self.cli.close()
        self.srv.stop()


def test_sparse_pull_matches_the_mirror_and_sgd():
    with _Server(ps, [ps.TableConfig(7, "sparse", 4, "sgd", lr=0.5,
                                     init_range=0.2, seed=7)]) as cli:
        cli.register_sparse(7, 4)
        keys = np.array([3, 99, 12345], np.uint64)
        got = cli.pull_sparse(7, keys)
        want = deterministic_init(7, keys, 4, 0.2)
        np.testing.assert_array_equal(want, ref_init(7, keys, 4, 0.2))
        np.testing.assert_allclose(got, want, rtol=INIT_RTOL)
        np.testing.assert_array_equal(got, server_init_rows(7, keys, 4, 0.2))
        cli.push_sparse_grad(7, keys, np.ones((3, 4), np.float32))
        np.testing.assert_allclose(cli.pull_sparse(7, keys), want - 0.5,
                                   rtol=RULE_RTOL)
        assert cli.sparse_size(7) == 3
        many = np.arange(1, 5001, dtype=np.uint64) * np.uint64(7919)
        np.testing.assert_array_equal(cli.pull_sparse(7, many),
                                      server_init_rows(7, many, 4, 0.2))


@pytest.mark.parametrize("ids_kind", ["numpy", "list"])
def test_lookup_of_host_ids_goes_to_the_asked_device(ids_kind):
    """Host ids land on ``device``; with none asked for they go to the
    card (here, with no card, the lookup raises rather than fall back to
    the CPU)."""
    import torch

    from paddle_tpu_torch.distributed.ps.communicator import SyncCommunicator
    ids = np.array([[3, 12], [99, 3]], np.int64)
    ids = ids if ids_kind == "numpy" else ids.tolist()
    with _Server(ps, [ps.TableConfig(7, "sparse", 4, "sgd", lr=0.5,
                                     init_range=0.2, seed=7)]) as cli:
        comm = SyncCommunicator(cli, n_workers=1)
        emb = ps.SparseEmbedding([100, 4], table_id=7, device="cpu")
        emb.bind(comm)
        out = emb(ids)
        assert out.device.type == "cpu" and tuple(out.shape) == (2, 2, 4)
        keys = np.asarray(ids, np.uint64).ravel()
        np.testing.assert_array_equal(
            out.detach().numpy().reshape(-1, 4),
            server_init_rows(7, keys, 4, 0.2))
        out2 = ps.distributed_lookup_table(ids, 7, comm, device="cpu")
        np.testing.assert_array_equal(out2.detach().numpy(),
                                      out.detach().numpy())
        comm._pending_slices = []
        default = ps.SparseEmbedding([100, 4], table_id=7)
        default.bind(comm)
        if torch.cuda.is_available():
            assert default(ids).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                default(ids)
        # tensor ids keep their own device whatever the layer's
        assert default(torch.as_tensor(np.asarray(ids))).device.type == "cpu"
        comm._pending_slices = []


def test_sparse_adam_matches_numpy():
    with _Server(ps, [ps.TableConfig(1, "sparse", 3, "adam", lr=0.1,
                                     init_range=0.0)]) as cli:
        cli.register_sparse(1, 3)
        keys = np.array([5], np.uint64)
        p, m, v = np.zeros(3), np.zeros(3), np.zeros(3)
        for t in range(1, 4):
            g = np.full(3, float(t), np.float32)
            cli.push_sparse_grad(1, keys, g.reshape(1, 3))
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            p -= 0.1 * (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t))
                                               + 1e-8)
        np.testing.assert_allclose(cli.pull_sparse(1, keys)[0], p,
                                   rtol=RULE_RTOL)


def test_dense_init_push_pull_and_delta():
    with _Server(ps, [ps.TableConfig(0, "dense", 0, "sgd", lr=0.1)]) as cli:
        cli.register_dense(0, 4)
        init = np.arange(4, dtype=np.float32)
        np.testing.assert_array_equal(cli.pull_dense_init(0, init), init)
        # a second init is ignored (the table is initialized)
        np.testing.assert_array_equal(
            cli.pull_dense_init(0, np.zeros(4, np.float32)), init)
        cli.push_dense_grad(0, np.ones(4, np.float32))
        np.testing.assert_allclose(cli.pull_dense(0), init - 0.1,
                                   rtol=RULE_RTOL)
        cli.push_dense_delta(0, np.full(4, 0.5, np.float32))
        np.testing.assert_allclose(cli.pull_dense(0), init + 0.4,
                                   rtol=RULE_RTOL)


def test_save_load_roundtrip_is_bitwise(tmp_path):
    tables = [ps.TableConfig(0, "dense", 0, "sgd", lr=0.1),
              ps.TableConfig(9, "sparse", 2, "adam", lr=0.05,
                             init_range=0.3, seed=9)]
    keys = np.array([11, 22], np.uint64)
    g = np.random.RandomState(0).rand(2, 2).astype(np.float32)
    with _Server(ps, tables) as cli:
        cli.register_dense(0, 3)
        cli.register_sparse(9, 2)
        cli.pull_dense_init(0, np.array([1, 2, 3], np.float32))
        cli.push_sparse_grad(9, keys, np.ones((2, 2), np.float32))
        want_sparse, want_dense = cli.pull_sparse(9, keys), cli.pull_dense(0)
        cli.save(str(tmp_path / "snap"))
        cli.push_sparse_grad(9, keys, g)  # the Adam state's ground truth
        want_next = cli.pull_sparse(9, keys)
    with _Server(ps, tables) as cli:
        cli.register_dense(0, 3)
        cli.register_sparse(9, 2)
        cli.load(str(tmp_path / "snap"))
        np.testing.assert_array_equal(cli.pull_sparse(9, keys), want_sparse)
        np.testing.assert_array_equal(cli.pull_dense(0), want_dense)
        cli.push_sparse_grad(9, keys, g)  # m, v and t came back too
        np.testing.assert_array_equal(cli.pull_sparse(9, keys), want_next)


def _spill_tables(path, budget, optimizer="sgd", lr=0.1):
    return [ps.TableConfig(1000, "sparse", 4, optimizer, lr=lr,
                           init_range=0.1, seed=1000,
                           mem_budget_rows=budget, spill_path=str(path))]


def test_spill_trains_past_the_budget_and_refaults_exactly(tmp_path):
    with _Server(ps, _spill_tables(tmp_path / "spill", 8)) as cli:
        cli.register_sparse(1000, 4)
        keys = np.arange(60, dtype=np.uint64)
        g = np.ones((60, 4), np.float32)
        cli.push_sparse_grad(1000, keys, g)
        in_mem, spilled, fails = cli.sparse_spill_info(1000)[0]
        assert in_mem <= 8 and spilled >= 52 and in_mem + spilled == 60
        assert fails == 0 and cli.sparse_size(1000) == 60
        mirror = deterministic_init(1000, keys, 4, 0.1) - 0.1
        np.testing.assert_allclose(cli.pull_sparse(1000, keys), mirror,
                                   rtol=RULE_RTOL, atol=1e-7)
        cli.push_sparse_grad(1000, keys[:5], g[:5])
        np.testing.assert_allclose(cli.pull_sparse(1000, keys[:5]),
                                   mirror[:5] - 0.1, rtol=RULE_RTOL,
                                   atol=1e-7)


def test_spilled_adam_equals_unbounded_and_survives_a_snapshot(tmp_path):
    keys = np.arange(40, dtype=np.uint64)
    rng = np.random.RandomState(2)
    grads = [rng.randn(40, 4).astype(np.float32) for _ in range(4)]
    snap = str(tmp_path / "snap")
    with _Server(ps, _spill_tables(tmp_path / "s1", 6, "adam", 0.05)) as cli:
        cli.register_sparse(1000, 4)
        for g in grads[:3]:
            cli.push_sparse_grad(1000, keys, g)
        cli.save(snap)
        mid = cli.pull_sparse(1000, keys)
        cli.push_sparse_grad(1000, keys, grads[3])
        spilled_vals = cli.pull_sparse(1000, keys)
        assert cli.sparse_spill_info(1000)[0][1] > 0
    with _Server(ps, [ps.TableConfig(1000, "sparse", 4, "adam", lr=0.05,
                                     init_range=0.1, seed=1000)]) as cli:
        cli.register_sparse(1000, 4)
        for g in grads:
            cli.push_sparse_grad(1000, keys, g)
        np.testing.assert_array_equal(spilled_vals,
                                      cli.pull_sparse(1000, keys))
    # a fresh budgeted server loads the snapshot (re-spilling past the
    # budget) and the same next push gives the same rows
    with _Server(ps, _spill_tables(tmp_path / "s2", 6, "adam", 0.05)) as cli:
        cli.register_sparse(1000, 4)
        cli.load(snap)
        in_mem, spilled, _ = cli.sparse_spill_info(1000)[0]
        assert in_mem <= 6 and in_mem + spilled == 40
        np.testing.assert_array_equal(cli.pull_sparse(1000, keys), mid)
        cli.push_sparse_grad(1000, keys, grads[3])
        np.testing.assert_array_equal(cli.pull_sparse(1000, keys),
                                      spilled_vals)


def test_push_retry_across_a_server_restart_applies_once():
    """The server stops; a push issued while it is down rides the retry
    policy until a replacement binds the same port, and lands exactly once
    on the replacement's fresh table (one Adam step from zeros)."""
    tables = [ps.TableConfig(0, "dense", 0, "adam", lr=0.05)]
    srv, port = _start(ps, tables)
    cli = _client(ps, port, retry_policy=RetryPolicy(
        max_attempts=20, base_delay_s=0.1, max_delay_s=0.3, deadline_s=30.0,
        seed=5))
    cli.CONNECT_RETRIES, cli.CONNECT_BACKOFF = 3, 0.05
    srv2 = [None]
    try:
        cli.register_dense(0, 6)
        cli.pull_dense_init(0, np.zeros(6, np.float32))
        cli.push_dense_grad(0, np.ones(6, np.float32))
        base = cli.pull_dense(0)
        srv.stop()

        def revive():
            time.sleep(0.5)
            srv2[0] = _start(ps, tables, port=port)[0]

        t = threading.Thread(target=revive)
        t.start()
        cli.push_dense_grad(0, np.ones(6, np.float32))
        t.join(timeout=30)
        np.testing.assert_array_equal(cli.pull_dense(0), base)
    finally:
        cli.stop_servers()
        cli.close()
        for s in (srv, srv2[0]):
            if s is not None:
                s.stop()


def _wire_ops(cli):
    """A fixed run of every table op; returns every row it leaves."""
    rng = np.random.RandomState(4)
    cli.register_sparse(1000, 4)
    cli.register_sparse(1001, 3)
    cli.register_dense(0, 5)
    keys = np.array([1, 7, 7, 1 << 40, 123456789], np.uint64)
    out = [cli.pull_sparse(1000, keys), cli.pull_sparse(1001, keys)]
    for _ in range(3):
        cli.push_sparse_grad(1000, keys, rng.randn(5, 4).astype(np.float32))
        cli.push_sparse_grad(1001, keys, rng.randn(5, 3).astype(np.float32))
    cli.push_sparse_delta(1000, keys[:2],
                          rng.randn(2, 4).astype(np.float32))
    out.append(cli.pull_dense_init(0, rng.randn(5).astype(np.float32)))
    for _ in range(2):
        cli.push_dense_grad(0, rng.randn(5).astype(np.float32))
    cli.push_dense_delta(0, rng.randn(5).astype(np.float32))
    out += [cli.pull_sparse(1000, keys), cli.pull_sparse(1001, keys),
            cli.pull_dense(0), np.array([cli.sparse_size(1000)])]
    return out


def _wire_tables(pkg):
    return [pkg.TableConfig(1000, "sparse", 4, "sgd", lr=0.1,
                            init_range=0.1, seed=1000),
            pkg.TableConfig(1001, "sparse", 3, "adam", lr=0.05,
                            init_range=0.2, seed=1001),
            pkg.TableConfig(0, "dense", 0, "adam", lr=0.01)]


@pytest.mark.parametrize("server,client", [("port", "ref"),
                                           ("ref", "port")])
def test_the_wire_across_packages_is_bitwise(server, client):
    pkgs = {"port": ps, "ref": ref_ps}
    with _Server(ps, _wire_tables(ps)) as cli:
        want = _wire_ops(cli)
    with _Server(pkgs[server], _wire_tables(pkgs[server]),
                 client_pkg=pkgs[client]) as cli:
        got = _wire_ops(cli)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_server_op_stats_name_the_ops():
    with _Server(ps, [ps.TableConfig(3, "sparse", 2, "sgd")]) as cli:
        cli.register_sparse(3, 2)
        cli.pull_sparse(3, np.array([1, 2], np.uint64))
        ops = {(r["table"], r["op"]) for r in ps.server.server_op_stats()}
        assert (3, "pull_sparse") in ops


_BROKEN_BUILD = r"""
import os, sys
import paddle_tpu_torch._native as n
n._SRCS = [os.path.join(sys.argv[1], "broken.cc")]
n.BUILD_DIR = sys.argv[1]
try:
    n.lib()
except n.NativeBuildError as e:
    print("RAISED", "g++ failed" in str(e), "not_a_type" in str(e))
else:
    print("BUILT")
"""


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    (tmp_path / "broken.cc").write_text("not_a_type x = ;\n")
    res = subprocess.run([sys.executable, "-c", _BROKEN_BUILD,
                          str(tmp_path)], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         timeout=120)
    assert res.stdout.split() == ["RAISED", "True", "True"], \
        res.stdout + res.stderr


def test_the_library_is_local_to_its_package():
    """Both packages' libraries are loaded in this process; each resolves
    its own symbols (RTLD_LOCAL), each holds its own server, and the
    port's library is named by the hash of its sources."""
    lib = _native.lib()
    assert os.path.basename(_native.library_path()).startswith(
        "libpaddle_tpu_torch_ps-")
    assert abs(lib.pt_prof_now_ns() - time.monotonic_ns()) < 10 ** 9
    a, pa = _start(ps, [ps.TableConfig(1, "sparse", 1, "sgd")])
    b, pb = _start(ref_ps, [ref_ps.TableConfig(1, "sparse", 1, "sgd")])
    try:
        assert pa != pb and lib.pt_ps_port() == pa
    finally:
        a.stop()
        b.stop()


def test_downpour_two_threads_train_from_dataset():
    """The reference's ``tests/test_parameter_server.py:270`` case through
    the port: two worker threads, each its own replica and
    ``AsyncCommunicator`` over one client, fed from a shared queue; a fresh
    replica that pulls the trained dense parameters beats chance
    decisively."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.nn import functional as F

    vocab, dim = 50, 4
    torch.set_num_threads(2)
    tables = [ps.TableConfig(1000, "sparse", dim, "sgd", lr=0.2,
                             init_range=0.1, seed=1000)] + [
        ps.TableConfig(i, "dense", 0, "sgd", lr=0.2) for i in range(4)]
    w_id = np.random.RandomState(42).randn(vocab).astype(np.float32)

    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            # an explicit table id: every replica addresses one table
            self.emb = ps.SparseEmbedding([vocab, dim], table_id=1000,
                                          device="cpu")
            self.fc1 = nn.Linear(3 * dim, 8, device="cpu")
            self.fc2 = nn.Linear(8, 1, device="cpu")

        def forward(self, ids):
            h = self.emb(ids).reshape(ids.shape[0], 3 * dim)
            return self.fc2(F.relu(self.fc1(h)))

    def builder():
        import paddle_tpu_torch as pt
        pt.seed(0)
        return M()

    def loss_fn(model, batch):
        ids, label = batch
        return F.binary_cross_entropy_with_logits(
            model(torch.from_numpy(ids)), torch.from_numpy(label))

    def batches(n):
        rng = np.random.RandomState(0)
        for _ in range(n):
            ids = rng.randint(0, vocab, (32, 3)).astype(np.int64)
            yield ids, (w_id[ids[:, 0]] > 0).astype(np.float32).reshape(-1, 1)

    with _Server(ps, tables) as cli:
        class Runtime:  # the PsRuntime surface the trainer reads
            client = cli

            class role:
                @staticmethod
                def worker_num():
                    return 1

        trainer = ps.DownpourTrainer(Runtime, builder, loss_fn, n_threads=2)
        stats = trainer.train_from_dataset(batches(250))
        assert stats["batches"] == 250 and stats["error"] is None
        assert all(c > 0 for c in stats["per_thread"])
        probe = builder()
        comm = SyncCommunicator(cli, n_workers=1)
        ps.bind_model(probe, comm)
        comm.pull_dense()
        ids, label = next(batches(1))
        with torch.no_grad():
            pred = probe(torch.from_numpy(ids)).numpy() > 0
        assert (pred.ravel() == (label.ravel() > 0.5)).mean() > 0.75
    ps.reset_registry()


def test_datasets_match_the_reference(tmp_path):
    from paddle_tpu.distributed import fleet as ref_fleet
    from paddle_tpu_torch.distributed import fleet
    rng = np.random.RandomState(1)
    files = []
    for f in range(2):
        path = tmp_path / f"part{f}.txt"
        path.write_text("".join(
            f"{rng.randint(100)} {rng.randint(100)}\t{rng.rand():.4f}\n"
            for _ in range(7)) + "\n")
        files.append(str(path))

    def run(mod):
        out = {}
        mem = mod.InMemoryDataset()
        mem.init(batch_size=3, use_var=["ids", "score"])
        mem.set_filelist(files)
        out["n"] = mem.load_into_memory()
        mem.local_shuffle(seed=5)
        out["local"] = [{k: v.tolist() for k, v in b.items()}
                        for b in mem.batches()]
        mem.global_shuffle(seed=2)
        out["global"] = [{k: v.tolist() for k, v in b.items()}
                         for b in mem.batches(drop_last=True)]
        q = mod.QueueDataset()
        q.init(batch_size=4, use_var=["ids", "score"])
        q.set_filelist(files)
        out["queue"] = [{k: v.tolist() for k, v in b.items()}
                        for b in q.batches()]
        try:
            q.load_into_memory()
        except RuntimeError as e:
            out["queue_load"] = str(e)
        return out

    got, want = run(fleet), run(ref_fleet)
    assert got == want and got["n"] == 14 and "streams" in got["queue_load"]


def test_role_makers_match_the_reference(monkeypatch):
    from paddle_tpu.distributed.fleet.base import role_maker as ref_rm
    from paddle_tpu_torch.distributed.fleet.base import role_maker as rm

    def probe(mod):
        out = []
        for env in ({}, {"TRAINING_ROLE": "PSERVER", "PADDLE_PSERVER_ID": "1",
                         "PADDLE_PSERVER_ENDPOINTS": "h:1,h:2",
                         "PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "4"},
                    {"PADDLE_TRAINER_ENDPOINTS": "a:1,b:2,c:3"}):
            for k in ("TRAINING_ROLE", "PADDLE_PSERVER_ID",
                      "PADDLE_PSERVER_ENDPOINTS", "PADDLE_TRAINER_ID",
                      "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ENDPOINTS"):
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            r = mod.PaddleCloudRoleMaker(is_collective=False)
            out.append((r._is_collective, r.is_server(), r.is_worker(),
                        r.worker_index(), r.worker_num(), r.is_first_worker(),
                        r.get_trainer_endpoints(), r.get_pserver_endpoints(),
                        r.server_index(), r.server_num()))
        u = mod.UserDefinedRoleMaker(current_id=1, role=mod.Role.SERVER,
                                     worker_num=3,
                                     server_endpoints=["s:1", "s:2"])
        out.append((u.is_server(), u.is_worker(), u.worker_index(),
                    u.server_index(), u.worker_num(),
                    u.get_pserver_endpoints(), u.server_num()))
        return out

    assert probe(rm) == probe(ref_rm)
