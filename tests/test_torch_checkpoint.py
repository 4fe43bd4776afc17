"""The port's step checkpoints on the CPU (``paddle_tpu_torch.checkpoint``,
``amp.GradScaler``, ``save``/``load``, ``incubate.auto_checkpoint``),
against the port itself: the counterpart of ``tests/test_checkpoint.py``.

Data-parallel cases run on gloo ranks that this file spawns as scripts
(a ``file://`` rendezvous under the test's temporary directory, one thread
each), once per world size; rank 0 writes every case's result and the
parametrised tests read theirs. The model is the reference checkpoint
tests' MLP (Linear(16, 32), ReLU, Linear(32, 8), AdamW at lr 0.05),
built from ``paddle_tpu_torch.seed``, at 1e-3 MB buckets (one parameter a
bucket, four buckets).

Bounds:

- a resume (save after call 1, fresh objects from another seed, restore,
  call 2) against the uninterrupted run of the same arm: bitwise, losses
  and parameters (tolerance 0), at dp = 2, for the replicated optimizer
  and ZeRO-1/2/3, each with an accumulation window of 2;
- elastic resume at another degree: the materialized parameters and
  moments bitwise equal to the saved run's; the continued losses within
  1e-6 relative of the saved degree's continuation (each rank's mean and
  the sum over ranks group the batch in other orders);
- everything else is exact: the kill-point sweeps, the fallback past a
  corrupt payload, GC, the counters, round trips of the scaler,
  ``save``/``load`` and the epoch loop.
"""
import gc
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
K, ACC = 2, 2
LR = 0.05
BUCKET_MB = 1e-3


def _batches(seed, k=K, batch=16):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(k, batch, 16).astype("float32")),
            torch.from_numpy(rng.randint(0, 8, (k, batch)).astype("int64")))


X1, Y1 = _batches(7)
X2, Y2 = _batches(8)


def spawn(workdir, world, task):
    """Run ``task`` on ``world`` gloo ranks; returns rank 0's result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(rank), str(world),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(Path(workdir) / f"{task}.pkl", "rb") as f:
        return pickle.load(f)


# -- models and programs ------------------------------------------------------

def mlp(seed):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    pt.seed(seed)

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.add_sublayer("0", nn.Linear(16, 32, device="cpu"))
            self.add_sublayer("2", nn.Linear(32, 8, device="cpu"))

        def forward(self, x):
            first, second = self._modules["0"], self._modules["2"]
            return second(torch.relu(first(x.to(first.weight.dtype))))
    return MLP()


def build(stage, seed=11, acc=ACC, scaler=None, k=K):
    """The k-step program over the mesh's dp axis, its model, optimizer."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.nn import functional as F
    m = mlp(seed)
    opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR)
    if stage:
        opt._zero_enable(axis="dp", stage=stage, comm_buffer_mb=BUCKET_MB)

    def one(xb, yb):
        loss = F.cross_entropy(m(xb).float(), yb)
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
        opt.clear_grad()
        return loss
    return jit.to_static(one, scan_steps=k, dp_axis="dp",
                         accumulate_steps=acc), m, opt


def manager(root, *objs, **kw):
    from paddle_tpu_torch import checkpoint
    mgr = checkpoint.CheckpointManager(str(root), **kw)
    for o in objs:
        if hasattr(o, "parameters") and not hasattr(o, "_param_groups"):
            mgr.add_model(o)
        elif hasattr(o, "_param_groups"):
            mgr.add_optimizer(o)
        else:
            mgr.add_scaler(o)
    return mgr


def materialized(opt, model):
    """{param name: {"param", "moment1", "moment2"}} as full numpy arrays
    (a ZeRO store gathered from every rank and cut into its parameters)."""
    # a copy first: .numpy() of the tensor itself would pin its storage,
    # which stage 3 must be able to release
    out = {n: {"param": p.detach().clone().numpy()}
           for n, p in model.named_parameters()}
    names = {id(p): n for n, p in model.named_parameters()}
    zero = opt._zero
    if zero is None:
        for (slot, pid), t in opt._accumulators.items():
            out[names[pid]][slot] = t.clone().numpy()
        return out
    for b in zero.buckets:
        for slot in ("moment1", "moment2"):
            full = torch.cat(zero.gather_shards(b.stores[slot]))
            for p, seg in zip(b.params, b.segments(full)):
                out[names[id(p)]][slot] = seg.clone().numpy()
    return out


# -- the ranks ----------------------------------------------------------------

MATRIX = [(0, False), (1, False), (2, False), (3, False), (1, True)]


def _resume_matrix(workdir):
    """{(stage, scaler): (step, losses bitwise, params bitwise)} of a resume
    into fresh objects against the uninterrupted run, an accumulation
    window of 2; with ``scaler`` a GradScaler scales every step and rides
    the checkpoint."""
    out = {}
    for stage, scaled in MATRIX:
        step, m, _ = build(stage, scaler=_edge_scaler() if scaled else None)
        step(X1, Y1)
        want = step(X2, Y2)
        want_params = [p.detach().clone() for p in m.parameters()]
        del step, m
        root = Path(workdir) / f"matrix{stage}{'_scaled' if scaled else ''}"
        sc = _edge_scaler() if scaled else None
        step, m, opt = build(stage, scaler=sc)
        step(X1, Y1)
        manager(root, m, opt, *([sc] if scaled else [])).save(1)
        del step, m, opt, sc
        gc.collect()
        sc = _edge_scaler() if scaled else None
        step, m, opt = build(stage, seed=99, scaler=sc)
        meta = manager(root, m, opt, *([sc] if scaled else [])).restore()
        got = step(X2, Y2)
        out[(stage, scaled)] = (meta["step"], torch.equal(got, want),
                                all(torch.equal(p, q) for p, q in
                                    zip(m.parameters(), want_params)))
        if scaled:  # the arm tells a scaler left out of the restore apart
            step, m, opt = build(stage, seed=99, scaler=_edge_scaler())
            manager(root, m, opt).restore()
            step(X2, Y2)
            out["scaler left out"] = not all(
                torch.equal(p, q) for p, q in zip(m.parameters(),
                                                  want_params))
    return out


def _gacc_round_trip(workdir):
    """Stage 3's window accumulator seeded, saved, clobbered, restored."""
    _, m, opt = build(3)
    seeded = []
    for b in opt._zero.buckets:
        g = b.stores["gacc"]
        val = torch.arange(g.numel(), dtype=torch.float32).view(g.shape)
        val += 1000.0 * opt._zero.rank
        lo = opt._zero.rank * b.shard_rows
        val[max(b.rows - b.pad_rows - lo, 0):] = 0.0  # padding holds nothing
        g.copy_(val)
        seeded.append(val)
    manager(Path(workdir) / "gacc", m, opt).save(1)
    for b in opt._zero.buckets:
        b.stores["gacc"].zero_()
    manager(Path(workdir) / "gacc", m, opt).restore()
    return all(torch.equal(b.stores["gacc"], v)
               for b, v in zip(opt._zero.buckets, seeded))


def _refusals(workdir):
    """{case: (exception type, message)} of restores that must fail."""
    from paddle_tpu_torch import checkpoint, optimizer

    def caught(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- the case under test
            return type(e).__name__, str(e)
        return None

    out = {}
    root3 = Path(workdir) / "refuse_zero3"
    _, m, opt = build(3, acc=None)
    manager(root3, m, opt).save(1)
    out["zero3 without optimizer"] = caught(
        lambda: manager(root3, m).restore())
    root1 = Path(workdir) / "refuse_zero1"
    _, m1, o1 = build(1, acc=None)
    manager(root1, m1, o1).save(1)
    _, m3, o3 = build(3, seed=99, acc=None)
    out["stage mismatch"] = caught(lambda: manager(root1, m3, o3).restore())
    m0 = mlp(1)
    o0 = optimizer.AdamW(parameters=m0.parameters())
    out["not sharded"] = caught(lambda: manager(root1, m0, o0).restore())
    _, mb, ob = build(1, acc=None)
    big = optimizer.AdamW(parameters=mlp(2).parameters())
    big._zero_enable(axis="dp", stage=1, comm_buffer_mb=1.0)
    out["bucket layout"] = caught(lambda: manager(root1, mb, big).restore())
    out["missing scaler"] = caught(lambda: checkpoint.CheckpointManager(
        str(root1)).add_scaler(_scaler()).restore())
    return out


def _scaler():
    from paddle_tpu_torch import amp
    return amp.GradScaler(init_loss_scaling=128.0)


def _edge_scaler():
    """A scale at float32's edge that doubles after every good step: call
    1's update doubles it to inf, so call 2's update is skipped, which a
    fresh scaler would take; a resume is bitwise only when the scaler's
    state is restored."""
    from paddle_tpu_torch import amp
    return amp.GradScaler(init_loss_scaling=2.0 ** 127, incr_every_n_steps=1,
                          decr_every_n_nan_or_inf=1)


def _elastic(workdir, world, rank):
    """Elastic resume in both directions on one world of 4: dp 2 runs on
    ranks {0, 1} (a subgroup), dp 4 on all four. Each direction saves
    after call 1, keeps the saved run's materialized state and its call 2,
    then restores at the other degree into fresh objects."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import parallel_env
    pair = dist.new_group([0, 1])  # every rank takes part in creating it
    meshes = {4: parallel_env.make_mesh({"dp": 4})}
    if rank < 2:
        meshes[2] = parallel_env.make_mesh({"dp": 2}, group=pair)
    out = {}
    for stage in (1, 3):
        for old, new in ((2, 4), (4, 2)):
            root = Path(workdir) / f"elastic{stage}_{old}to{new}"
            if rank < old:
                parallel_env.set_mesh(meshes[old])
                step, m, opt = build(stage, acc=None)
                step(X1, Y1)
                manager(root, m, opt).save(1)
                saved = materialized(opt, m)
                cont = step(X2, Y2)
                del step, m, opt
                gc.collect()
            dist.barrier()
            if rank < new:
                parallel_env.set_mesh(meshes[new])
                step, m, opt = build(stage, seed=99, acc=None)
                meta = manager(root, m, opt).restore()
                got = materialized(opt, m)
                layout = opt.zero_layout()
                losses = step(X2, Y2)
                if rank == 0:
                    same = all(np.array_equal(got[n][s], saved[n][s])
                               for n in saved for s in saved[n])
                    rel = float(((losses - cont).abs() / cont.abs()).max())
                    out[(stage, old, new)] = (
                        meta["zero"]["opt"]["degree"], layout["degree"],
                        layout["shard_rows"], layout["bucket_rows"], same,
                        rel)
                del step, m, opt
                gc.collect()
            dist.barrier()
    parallel_env.set_mesh(meshes[4])
    return out


def _pod(workdir, rank):
    """PodCheckpointManager at world 2: a ZeRO-3 resume through it, and a
    fault at every pod kill point on the rank that reaches it."""
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.checkpoint import multihost
    from paddle_tpu_torch.testing import faults
    out = {}
    root = Path(workdir) / "pod"
    step, m, _ = build(3, acc=None)
    step(X1, Y1)
    want = step(X2, Y2)
    step, m, opt = build(3, acc=None)
    step(X1, Y1)
    checkpoint.PodCheckpointManager(str(root), timeout=120.0) \
        .add_model(m).add_optimizer(opt).save(1)
    step, m, opt = build(3, seed=99, acc=None)
    meta = checkpoint.PodCheckpointManager(str(root)).add_model(
        m).add_optimizer(opt).restore()
    out["resume"] = (meta["step"], meta["pod"]["world"],
                     torch.equal(step(X2, Y2), want),
                     sorted(os.listdir(root / "step_0000000001")))
    sweep = {}
    for point in multihost.POD_KILL_POINTS:
        kroot = str(Path(workdir) / ("pod_" + point.replace("/", "_")))
        # the saves that must publish wait long; the faulted one's other
        # rank gives up after a few seconds
        mgr, faulted = (checkpoint.PodCheckpointManager(
            kroot, timeout=t, include_rng=False).add_model(m)
            .add_optimizer(opt) for t in (120.0, 3.0))
        mgr.save(1)
        faults.reset()
        # the committer's points fire on rank 0, the shard points on rank 1
        if (rank == 0) == point.endswith("commit"):
            faults.inject(point)
        try:
            faulted.save(2)
            raised = None
        except Exception as e:  # noqa: BLE001 -- the case under test
            raised = type(e).__name__
        faults.reset()
        torch.distributed.barrier()
        sweep[point] = (raised, mgr.restore()["step"])
        torch.distributed.barrier()
        mgr.save(3)  # the writers recover
        sweep[point] += (mgr.latest_step(),)
    out["sweep"] = sweep
    return out


def _rank_main(task, rank, world, workdir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.init_parallel_env(
        device="cpu", init_method=f"file://{workdir}/rendezvous_{task}",
        world_size=world, rank=rank)
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": world}))
    if task == "dp2":
        out = {"matrix": _resume_matrix(workdir),
               "gacc": _gacc_round_trip(workdir),
               "refusals": _refusals(workdir),
               "pod": _pod(workdir, rank)}
    else:
        out = _elastic(workdir, world, rank)
    if rank == 0:
        with open(Path(workdir) / f"{task}.pkl", "wb") as f:
            pickle.dump(out, f)
    torch.distributed.barrier()
    # drops the mesh's groups too, so gloo's threads are joined here and
    # not at interpreter exit (F11)
    parallel_env.destroy_parallel_env()


# -- the data-parallel tests --------------------------------------------------

@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("ckpt_dp2"), 2, "dp2")


@pytest.fixture(scope="module")
def dp4(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("ckpt_dp4"), 4, "dp4")


@pytest.mark.parametrize("stage, scaled", MATRIX,
                         ids=[f"zero{s}{'-scaler' if c else ''}"
                              for s, c in MATRIX])
def test_bitwise_resume_matrix(dp2, stage, scaled):
    """Save after call 1, fresh objects from another seed, restore, call
    2: losses and parameters bitwise the uninterrupted run's, at dp = 2
    with an accumulation window of 2 (params, moments, masters, @step,
    @lr, the ZeRO stores and, with a GradScaler, its scale and counts
    round-trip)."""
    step, losses_bitwise, params_bitwise = dp2["matrix"][(stage, scaled)]
    assert step == 1 and losses_bitwise and params_bitwise
    if scaled:
        assert dp2["matrix"]["scaler left out"]


def test_zero_gacc_window_store_round_trip(dp2):
    assert dp2["gacc"]


@pytest.mark.parametrize("case, kind, match", [
    ("zero3 without optimizer", "StateMismatchError", "ZeRO-3 store view"),
    ("stage mismatch", "StateMismatchError", "stage"),
    ("not sharded", "StateMismatchError", "ZeRO"),
    ("bucket layout", "StateMismatchError", "bucket layout"),
    ("missing scaler", "StateMismatchError", "no payload")])
def test_restore_refuses_a_mismatch(dp2, case, kind, match):
    got = dp2["refusals"][case]
    assert got is not None and got[0] == kind and match in got[1], got


@pytest.mark.parametrize("stage", [1, 3])
@pytest.mark.parametrize("old, new", [(2, 4), (4, 2)])
def test_elastic_resume_at_another_dp_degree(dp4, stage, old, new):
    saved_degree, live_degree, shard_rows, bucket_rows, same, rel = dp4[
        (stage, old, new)]
    assert (saved_degree, live_degree) == (old, new)
    assert shard_rows == [r // new for r in bucket_rows]
    assert same
    assert rel <= 1e-6, rel


def test_pod_checkpoint_resume_at_world_2(dp2):
    step, world, bitwise, files = dp2["pod"]["resume"]
    assert (step, world, bitwise) == (1, 2, True)
    assert {"rank0__model_model.pkl", "rank1__model_model.pkl",
            "rank0__optimizer_opt.pkl", "rank1__optimizer_opt.pkl",
            "rank0__rng.pkl", "manifest.json"} <= set(files)


@pytest.mark.parametrize("point", [
    "checkpoint/pod_shard_partial", "checkpoint/pod_shard_written",
    "checkpoint/pod_before_commit", "checkpoint/pod_after_commit"])
def test_pod_kill_point_never_publishes_a_torn_checkpoint(dp2, point):
    """A fault at a pod kill point fails the save on every rank (the
    faulted one raises it, the other times out waiting) and restore finds
    the previous checkpoint, or the complete new one after the commit;
    the next save publishes."""
    raised, restored, after = dp2["pod"]["sweep"][point]
    assert raised in ("FaultInjected", "PodCheckpointError")
    assert restored == (2 if point.endswith("after_commit") else 1)
    assert after == 3


# -- one process --------------------------------------------------------------

@pytest.fixture(autouse=True)
def _clean():
    from paddle_tpu_torch.testing import faults
    faults.reset()
    yield
    faults.reset()


def test_kill_point_sweep_never_accepts_torn_checkpoint(tmp_path):
    """A fault at every write stage leaves restore on the previous
    checkpoint (stages before the publish) or on the complete new one
    (after it), never on a torn one; the next save publishes."""
    from paddle_tpu_torch.checkpoint import core
    from paddle_tpu_torch.testing import faults
    published_after = {"checkpoint/after_publish", "checkpoint/before_gc"}
    assert len(core.KILL_POINTS) == 8
    for kp in core.KILL_POINTS:
        root = str(tmp_path / kp.replace("/", "_"))
        core.write_checkpoint(root, 1, {"a.pkl": b"A" * 64}, meta={"v": 1})
        faults.inject(kp)
        with pytest.raises(faults.FaultInjected):
            core.write_checkpoint(root, 2, {"a.pkl": b"B" * 64},
                                  meta={"v": 2})
        assert faults.fired(kp) == 1
        faults.clear()
        step, payloads, meta = core.read_checkpoint(root)
        if kp in published_after:
            assert step == 2 and payloads["a.pkl"] == b"B" * 64, kp
        else:
            assert step == 1 and payloads["a.pkl"] == b"A" * 64, kp
            assert meta == {"v": 1}
        core.write_checkpoint(root, 3, {"a.pkl": b"C" * 64})
        assert core.read_checkpoint(root)[0] == 3, kp


def test_kill_point_sweep_through_the_manager(tmp_path):
    """The sweep through CheckpointManager on a real model and optimizer:
    whatever restore accepts is exactly one of the two saved states."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.checkpoint import core
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.testing import faults
    m = mlp(3)
    opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR)

    def train():
        F.cross_entropy(m(X1[0]), Y1[0]).backward()
        opt.step()
        opt.clear_grad()
        return [p.detach().clone() for p in m.parameters()]

    for kp in core.KILL_POINTS:
        root = tmp_path / kp.replace("/", "_")
        first = train()
        manager(root, m, opt).save(1)
        second = train()
        faults.inject(kp)
        with pytest.raises(faults.FaultInjected):
            manager(root, m, opt).save(2)
        faults.clear()
        fresh = mlp(99)
        fresh_opt = optimizer.AdamW(parameters=fresh.parameters())
        meta = manager(root, fresh, fresh_opt).restore()
        want = second if meta["step"] == 2 else first
        assert all(torch.equal(p, q) for p, q in zip(fresh.parameters(),
                                                     want)), kp
        assert int(fresh_opt._step_count) == int(opt._step_count) - (
            meta["step"] == 1)


def test_corrupt_payload_falls_back_and_counts(tmp_path):
    from paddle_tpu_torch import checkpoint, monitor
    from paddle_tpu_torch.checkpoint import core
    root = str(tmp_path)
    core.write_checkpoint(root, 1, {"a.pkl": b"AAAA"})
    core.write_checkpoint(root, 2, {"a.pkl": b"BBBB"})
    with open(os.path.join(root, core.step_dirname(2), "a.pkl"), "r+b") as f:
        f.write(b"Z")
    monitor.stat_reset("checkpoint_corrupt_skipped_total")
    step, payloads, _meta = core.read_checkpoint(root)
    assert step == 1 and payloads["a.pkl"] == b"AAAA"
    assert monitor.stat_get("checkpoint_corrupt_skipped_total") == 1
    with pytest.raises(checkpoint.CheckpointCorruptError):
        core.read_checkpoint(root, step=2)


def test_gc_keeps_last_n_and_sweeps_staging(tmp_path):
    from paddle_tpu_torch.checkpoint import core
    root = str(tmp_path)
    for i in range(5):
        core.write_checkpoint(root, i, {"a.pkl": bytes([i])}, keep_last_n=2)
    assert core.valid_steps(root) == [3, 4]
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read() == "step_0000000004\n"
    # this process's abandoned staging dir is swept; a live writer's stays
    mine = os.path.join(root, f".staging.step_0000000009.{os.getpid()}")
    os.makedirs(mine)
    peer = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(30)"])
    try:
        theirs = os.path.join(root, f".staging.step_0000000008.{peer.pid}")
        os.makedirs(theirs)
        core.gc_checkpoints(root, 2)
        assert not os.path.exists(mine) and os.path.exists(theirs)
    finally:
        peer.kill()
        peer.wait()
    core.gc_checkpoints(root, 2)
    assert not os.path.exists(theirs)
    with pytest.raises(ValueError, match="keep_last_n"):
        core.gc_checkpoints(root, 0)


def test_checkpoint_counters_spans_and_manifest_meta(tmp_path):
    from paddle_tpu_torch import monitor, optimizer
    from paddle_tpu_torch.observability import runlog, tracing
    for name in ("checkpoint_saves_total", "checkpoint_restores_total",
                 "checkpoint_bytes_written_total"):
        monitor.stat_reset(name)
    m = mlp(0)
    opt = optimizer.Adam(parameters=m.parameters())
    mgr = manager(tmp_path / "ckpt", m, opt, keep_last_n=3)
    assert mgr.restore() is None and mgr.latest_step() is None
    tracing.reset()
    tracing.enable(categories=["checkpoint"])
    log = runlog.start_run(dir=str(tmp_path / "runlog"))
    try:
        mgr.save(5, extra_meta={"epoch": 2})
        meta = mgr.restore()
    finally:
        runlog.stop_run()
        tracing.disable()
    assert meta["step"] == 5 and meta["epoch"] == 2
    assert meta["components"] == ["model_model.pkl", "optimizer_opt.pkl",
                                  "rng.pkl"]
    assert mgr.steps() == [5]
    assert monitor.stat_get("checkpoint_saves_total") == 1
    assert monitor.stat_get("checkpoint_restores_total") == 1
    assert monitor.stat_get("checkpoint_bytes_written_total") > 0
    names = [s["name"] for s in tracing.spans()]
    for want in ("checkpoint/capture", "checkpoint/write_data",
                 "checkpoint/write_manifest", "checkpoint/publish",
                 "checkpoint/save", "checkpoint/restore"):
        assert want in names, want
    with open(log.path) as f:
        text = f.read()
    assert '"checkpoint_publish"' in text and '"checkpoint_restore"' in text


def test_write_checkpoint_validates_its_arguments(tmp_path):
    from paddle_tpu_torch.checkpoint import core
    with pytest.raises(ValueError, match="at least one payload"):
        core.write_checkpoint(str(tmp_path), 1, {})
    for bad in ("manifest.json", ".hidden", "a/b"):
        with pytest.raises(ValueError, match="invalid payload file name"):
            core.write_checkpoint(str(tmp_path), 1, {bad: b"x"})
    with pytest.raises(TypeError, match="must be bytes"):
        core.write_checkpoint(str(tmp_path), 1, {"a": "text"})
    with pytest.raises(NotImplementedError, match="LocalFS"):
        core.write_checkpoint(str(tmp_path), 1, {"a": b"x"}, fs=object())


def test_mid_window_restore_eager(tmp_path):
    """A checkpoint taken with accumulated but unconsumed gradients hands
    them back; finishing the window after the restore is bitwise the
    uninterrupted window."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import functional as F

    def build_eager(seed=11):
        m = mlp(seed)
        return m, optimizer.AdamW(parameters=m.parameters(),
                                  learning_rate=LR)

    def micro(m, i):
        F.cross_entropy(m(X1[i]), Y1[i]).backward()

    m0, o0 = build_eager()
    micro(m0, 0)
    micro(m0, 1)
    o0.step()
    want = [p.detach().clone() for p in m0.parameters()]
    mA, oA = build_eager()
    micro(mA, 0)
    manager(tmp_path, mA, oA).save(7)
    mB, oB = build_eager(seed=99)
    manager(tmp_path, mB, oB).restore()
    assert all(p.grad is not None for p in mB.parameters())
    micro(mB, 1)
    oB.step()
    assert all(torch.equal(p, q) for p, q in zip(mB.parameters(), want))


def test_restore_writes_in_place(tmp_path):
    """A restore into the same objects keeps every address a captured
    graph reads (parameters, moments, masters, @step, @lr, the scaler)
    and rebinds nothing, with bf16 parameters and float32 masters."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import functional as F
    m = mlp(5).to("bfloat16")
    opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR,
                          multi_precision=True)
    scaler = _scaler()
    F.cross_entropy(m(X1[0]).float(), Y1[0]).backward()
    opt.step()
    opt.clear_grad()
    manager(tmp_path, m, opt, scaler).save(1)
    tensors = ([p for p in m.parameters()]
               + list(opt._accumulators.values())
               + [opt._step_count, opt._lr.tensor, scaler._scale])
    saved = [t.detach().clone() for t in tensors]
    ptrs = [t.data_ptr() for t in tensors]
    F.cross_entropy(m(X1[1]).float(), Y1[1]).backward()
    opt.step()
    opt.clear_grad()
    opt.set_lr(0.5)
    scaler.set_init_loss_scaling(4.0)
    manager(tmp_path, m, opt, scaler).restore()
    assert [t.data_ptr() for t in tensors] == ptrs
    assert all(torch.equal(t, s) for t, s in zip(tensors, saved))
    assert opt.get_lr() == np.float32(LR)
    assert sorted({slot for slot, _ in opt._accumulators}) == [
        "master", "moment1", "moment2"]


def test_random_state_round_trip_and_foreign_record(tmp_path):
    """The generators' states round-trip (the draws after a restore repeat
    the draws after the save); the reference's record (a JAX key) is
    refused with its reason."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.checkpoint import state
    pt.seed(3)
    g = pt.default_generator("cpu")
    torch.rand(4, generator=g)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1)
    want = torch.rand(8, generator=g)
    pt.seed(77)
    assert mgr.restore()["components"] == ["rng.pkl"]
    assert torch.equal(torch.rand(8, generator=pt.default_generator("cpu")),
                       want)
    with pytest.raises(checkpoint.StateMismatchError,
                       match="include_rng=False"):
        state.restore_rng({"key": np.zeros(2, np.uint32)})


def test_grad_scaler_state_round_trip(tmp_path):
    """The scale and the good/bad counts round-trip through a checkpoint
    and through state_dict, in place."""
    from paddle_tpu_torch import amp
    s = amp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=3,
                       decr_every_n_nan_or_inf=1)
    s._good_steps.fill_(2)
    s._bad_steps.fill_(1)
    manager(tmp_path, s).save(1)
    s.set_init_loss_scaling(1.0)
    s._good_steps.zero_()
    state = s.state_dict()
    ptr = s._scale.data_ptr()
    manager(tmp_path, s).restore()
    assert s._scale.data_ptr() == ptr
    assert (s.get_init_loss_scaling(), int(s._good_steps),
            int(s._bad_steps)) == (64.0, 2, 1)
    s.load_state_dict(state)
    assert (s.get_init_loss_scaling(), int(s._good_steps)) == (1.0, 0)
    assert not amp.GradScaler(enable=False).is_enable()
    assert amp.AmpScaler is amp.GradScaler


def test_grad_scaler_skips_a_step_with_an_inf():
    """A step whose gradients hold an inf leaves the parameters, moments
    and @step as they were and halves the scale; a finite step updates as
    the unscaled step would (float32, scale a power of two: exact)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.nn import functional as F

    def run(scaled, poison):
        m = mlp(4)
        opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR)
        s = amp.GradScaler(init_loss_scaling=128.0,
                           decr_every_n_nan_or_inf=1, incr_every_n_steps=2)
        for i in range(3):
            loss = F.cross_entropy(m(X1[i % K]), Y1[i % K])
            if scaled:
                s.scale(loss).backward()
                if i == poison:
                    m.parameters()[0].grad[0, 0] = float("inf")
                s.step(opt)
            elif i != poison:
                loss.backward()
                opt.step()
            opt.clear_grad()
        return m, opt, s

    m, opt, s = run(True, poison=1)
    m_ref, opt_ref, _ = run(False, poison=1)
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(),
                                                 m_ref.parameters()))
    assert int(opt._step_count) == 2
    # step 0 good (1 of 2), step 1 inf (halved, counts reset), step 2 good
    assert (s.get_init_loss_scaling(), int(s._good_steps),
            int(s._bad_steps)) == (64.0, 1, 0)


def test_save_load_round_trip(tmp_path):
    import paddle_tpu_torch as pt
    obj = {"w": torch.arange(6, dtype=torch.float32).view(2, 3),
           "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
           "nested": [torch.ones(2, dtype=torch.int64), 3, "x"],
           "p": torch.nn.Parameter(torch.zeros(2))}
    path = str(tmp_path / "sub" / "obj.pdparams")
    pt.save(obj, path)
    got = pt.load(path, place="cpu")
    assert torch.equal(got["w"], obj["w"])
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"],
                                                            obj["h"])
    assert torch.equal(got["nested"][0], obj["nested"][0])
    assert got["nested"][1:] == [3, "x"]
    assert got["p"].requires_grad and not got["w"].requires_grad
    assert isinstance(pt.load(path, return_numpy=True)["w"], np.ndarray)


def test_bfloat16_without_ml_dtypes_is_widened_exactly(tmp_path,
                                                      monkeypatch):
    """Where ``ml_dtypes`` is not installed, bf16 tensors are written as
    float32 (exact) and come back as bf16: through a checkpoint and through
    ``save``/``load``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.checkpoint import state
    monkeypatch.setattr(state, "_bfloat16", lambda: None)
    m = mlp(8).to("bfloat16")
    opt = optimizer.AdamW(parameters=m.parameters(), multi_precision=True)
    assert state.capture_model(m)["state"]["0.weight"].dtype == np.float32
    manager(tmp_path / "ckpt", m, opt).save(1)
    fresh = mlp(9).to("bfloat16")
    fresh_opt = optimizer.AdamW(parameters=fresh.parameters(),
                                multi_precision=True)
    manager(tmp_path / "ckpt", fresh, fresh_opt).restore()
    assert all(p.dtype == torch.bfloat16 and torch.equal(p, q)
               for p, q in zip(fresh.parameters(), m.parameters()))
    h = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    pt.save({"h": h}, str(tmp_path / "h.pdparams"))
    got = pt.load(str(tmp_path / "h.pdparams"), place="cpu")["h"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, h)


def test_train_epoch_range_resumes_after_the_last_saved_epoch(
        tmp_path, monkeypatch):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.incubate import auto_checkpoint
    from paddle_tpu_torch.nn import functional as F
    monkeypatch.setenv("PADDLE_AUTO_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_JOB_ID", "job")

    def job(stop_after):
        m = mlp(6)
        opt = optimizer.Adam(parameters=m.parameters(), learning_rate=LR)
        r = auto_checkpoint.train_epoch_range(4, name="mlp")
        r.add_model(m).add_optimizer(opt)
        seen = []
        for epoch in r:
            seen.append(epoch)
            F.cross_entropy(m(X1[epoch % K]), Y1[epoch % K]).backward()
            opt.step()
            opt.clear_grad()
            if epoch == stop_after:
                break  # the job dies before this epoch's save
        return seen, m, r

    seen, _, _ = job(stop_after=2)
    assert seen == [0, 1, 2]
    seen, m, r = job(stop_after=None)
    assert seen == [2, 3] and r.restored_from == 1
    full, m_full, _ = job(stop_after=None)  # epoch 3 saved: nothing left
    assert full == []
    m_ref = mlp(6)
    opt_ref = optimizer.Adam(parameters=m_ref.parameters(), learning_rate=LR)
    for epoch in range(4):
        F.cross_entropy(m_ref(X1[epoch % K]), Y1[epoch % K]).backward()
        opt_ref.step()
        opt_ref.clear_grad()
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(),
                                                 m_ref.parameters()))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
