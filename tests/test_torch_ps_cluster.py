"""The port's parameter-server cluster on the CPU: one server process and
worker processes of ``paddle_tpu_torch.testing.ps_fixture`` through the
fleet (``fleet.init(is_collective=False)``, ``init_server``/``run_server``,
``init_worker``, ``ps_step``, ``save_persistables``, ``stop_worker``,
``shutdown_servers``), in sync, async and geo modes, all clusters started
together.

- Sync, two workers: the first ``REF_STEPS`` losses of each worker within
  ``SYNC_RTOL`` of the reference's sync run of the same fixture (its model,
  batches and dense initial weights, which the port's workers load; the
  reference's two workers run as threads of this process against its
  server). Two workers' pushes land in either order, so the sums round
  differently from run to run: hence a tolerance, not bitwise.
- Sync and async, two workers: the losses fall as the reference's cluster
  tests require, and both workers end with the same dense parameters.
- Async: worker 0's snapshot is written and counts the sparse rows.
- Geo with k = 1 and one worker matches the local emulation within the
  reference's bound (``GEO_RTOL``, ``GEO_ATOL``).
"""
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ps_ctr_runner.py")
STEPS = 200
REF_STEPS = 8
SYNC_RTOL = 1e-4
GEO_RTOL, GEO_ATOL = 2e-3, 2e-4


def _ref_fixture():
    spec = importlib.util.spec_from_file_location("ref_ps_ctr_runner",
                                                  REF_FIXTURE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(role, mode, endpoint, init, wid=0, nw=1, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "PS_", "JAX_"))}
    env.update(PYTHONPATH=ROOT, PYTHONFAULTHANDLER="1", PS_ROLE=role,
               PS_MODE=mode,
               TRAINING_ROLE="PSERVER" if role == "server" else "TRAINER",
               PADDLE_PSERVER_ENDPOINTS=endpoint, PADDLE_PSERVER_ID="0",
               PADDLE_TRAINER_ID=str(wid), PADDLE_TRAINERS_NUM=str(nw),
               PS_FIX_DEVICE="cpu", PS_FIX_STEPS=str(STEPS),
               PS_FIX_INIT=init)
    env.update(extra or {})
    return env


def _spawn(env):
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.testing.ps_fixture"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def _losses(text):
    return [float(m.group(2)) for m in
            re.finditer(r"LOSS (\d+) ([\d.eE+-]+)", text)]


def _field(text, name):
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return m and m.group(1)


class _Cluster:
    """One server and ``n`` workers of the port's fixture."""

    def __init__(self, mode, n, init, extra=None):
        self.srv = _spawn(_env("server", mode, "127.0.0.1:0", init,
                               extra=extra))
        self.mode, self.n, self.init, self.extra = mode, n, init, extra
        self.workers = []

    def start_workers(self):
        line = self.srv.stdout.readline()
        assert line.startswith("SERVER_READY"), \
            line + self.srv.stderr.read()[-3000:]
        endpoint = f"127.0.0.1:{line.split()[1]}"
        self.workers = [_spawn(_env("worker", self.mode, endpoint,
                                    self.init, i, self.n, self.extra))
                        for i in range(self.n)]

    def finish(self, timeout=240):
        outs = []
        try:
            for w in self.workers:
                out, err = w.communicate(timeout=timeout)
                assert w.returncode == 0, f"worker failed:\n{err[-4000:]}"
                outs.append(out)
            self.srv.wait(timeout=60)
            assert self.srv.returncode == 0, self.srv.stderr.read()[-3000:]
        finally:
            for p in self.workers + [self.srv]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return outs


def _ref_sync(mod, steps):
    """The reference fixture's sync mode for two workers, in lockstep on
    this thread against one in-process reference server: each step both
    workers' forward and backward, then both pushes (gradients / 2), then
    both pulls, which is what the sync communicator's two barriers order
    (one thread: no barrier is needed, and no second jax thread can race
    the first); returns each worker's losses."""
    from paddle_tpu.distributed import ps as ref_ps
    from paddle_tpu.distributed.ps.communicator import SyncCommunicator
    from paddle_tpu.distributed.ps.embedding import (flush_sparse_grads,
                                                     reset_registry)
    import paddle_tpu as paddle
    tables = [ref_ps.TableConfig(1000, "sparse", mod.DIM, "sgd", lr=mod.LR,
                                 init_range=0.1, seed=1000)] + [
        ref_ps.TableConfig(i, "dense", 0, "sgd", lr=mod.LR)
        for i in range(4)]
    srv = ref_ps.PsServer(tables, port=0)
    port = srv.start()
    models, comms = [], []
    try:
        for _ in range(2):
            reset_registry()
            paddle.seed(0)
            models.append(mod.CtrModel())
            comms.append(SyncCommunicator(
                ref_ps.PsClient([f"127.0.0.1:{port}"]), n_workers=2))
            ref_ps.bind_model(models[-1], comms[-1])
            comms[-1].init_params()
        reset_registry()
        losses = [[], []]
        for step in range(steps):
            for wid in (0, 1):
                ids, label = mod.synth_batch(step, wid, 2)
                loss = mod.loss_fn(models[wid](paddle.to_tensor(ids)), label)
                loss.backward()
                flush_sparse_grads(comms[wid])
                losses[wid].append(float(loss.numpy()))
            for comm in comms:
                for table_id, keys, grads in comm._sparse_push:
                    comm.client.push_sparse_grad(table_id, keys, grads / 2)
                comm._sparse_push.clear()
                for table_id, p in comm._dense:
                    comm.client.push_dense_grad(
                        table_id, np.asarray(p._grad, np.float32).ravel() / 2)
                    p._grad = None
            for comm in comms:
                comm.pull_dense()
        return losses
    finally:
        for comm in comms:
            comm.client.close()
        srv.stop()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ps_cluster")
    mod = _ref_fixture()
    import paddle_tpu as paddle
    from paddle_tpu.distributed.ps.embedding import reset_registry
    reset_registry()
    paddle.seed(0)
    init = str(tmp / "init.npz")
    np.savez(init, **{k: np.asarray(v) for k, v in
                      mod.CtrModel().state_dict().items()})
    reset_registry()
    snap = str(tmp / "snap")
    clusters = {"sync": _Cluster("sync", 2, init),
                "async": _Cluster("async", 2, init, {"PS_SAVE": snap}),
                "geo": _Cluster("geo", 1, init, {"PS_K_STEPS": "1"})}
    local = _spawn(_env("local", "sync", "", init))
    for c in clusters.values():
        c.start_workers()
    ref = _ref_sync(mod, REF_STEPS)
    outs = {k: c.finish() for k, c in clusters.items()}
    out, err = local.communicate(timeout=240)
    assert local.returncode == 0, err[-3000:]
    outs["local"] = [out]
    return outs, ref, snap


def test_sync_losses_match_the_reference_cluster(runs):
    outs, ref, _ = runs
    for wid, out in enumerate(outs["sync"]):
        np.testing.assert_allclose(_losses(out)[:REF_STEPS], ref[wid],
                                   rtol=SYNC_RTOL)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_two_workers_train_and_agree(runs, mode):
    outs, _, _ = runs
    for out in outs[mode]:
        ls = _losses(out)
        assert len(ls) == STEPS and np.isfinite(ls).all()
        assert np.mean(ls[-10:]) < 0.35 < np.mean(ls[:5])
    digests = {_field(out, "PARAMS") for out in outs[mode]}
    assert len(digests) == 1 and None not in digests


def test_async_saves_a_snapshot(runs):
    outs, _, snap = runs
    assert os.path.exists(snap + ".0")
    assert int(_field(outs["async"][0], "SPARSE_SIZE")) > 0


def test_geo_single_worker_matches_local(runs):
    outs, _, _ = runs
    geo, local = _losses(outs["geo"][0]), _losses(outs["local"][0])
    assert len(geo) == len(local) == STEPS
    np.testing.assert_allclose(geo, local, rtol=GEO_RTOL, atol=GEO_ATOL)


def test_fleet_in_ps_mode_in_process():
    """``fleet.init`` with a non-collective role builds the PS runtime and
    no mesh; the role decides ``is_server``; ``distributed_optimizer``
    passes the optimizer (and ``strategy.a_sync``) through; a collective
    fleet's PS entry points raise by name (``tests/test_torch_fleet.py``)."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet, parallel_env, ps
    from paddle_tpu_torch.distributed.fleet import UserDefinedRoleMaker
    from paddle_tpu_torch.distributed.fleet.base import fleet_base
    from paddle_tpu_torch.distributed.fleet.base.role_maker import Role
    s = fleet.DistributedStrategy()
    s.a_sync = True
    try:
        rt = fleet.init(UserDefinedRoleMaker(
            is_collective=False, current_id=0, role=Role.SERVER,
            worker_num=2, server_endpoints=["127.0.0.1:0"]), strategy=s)
        assert isinstance(rt, ps.PsRuntime) and rt._mode() == "async"
        assert fleet.ps_runtime() is rt and fleet.is_server()
        assert not fleet.is_worker() and fleet.worker_num() == 2
        assert parallel_env.current_mesh() is None
        opt = optimizer.SGD(parameters=[torch.nn.Parameter(torch.zeros(2))])
        assert fleet.distributed_optimizer(opt) is opt
    finally:
        fleet_base._ps_runtime = fleet_base._role_maker = None
        fleet_base._strategy = None
