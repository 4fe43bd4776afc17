"""ZeRO-1/2/3 data parallelism of the port on the CPU, over gloo.

A module fixture spawns the ranks once per world size (processes that run
this file as a script, with a ``file://`` rendezvous under the test's
temporary directory and one thread each); rank 0 writes every arm's result
and the parametrised cases read their arm's. The model is the reference
ZeRO tests' MLP (``tests/test_zero_sharding.py``: Linear(16, 32), ReLU,
Linear(32, 8), AdamW at lr 0.05) with the reference's weights moved over by
``bridge``, at 1e-3 MB buckets (one parameter a bucket, so the pipelined
schedule runs over four buckets), on a global batch of 16 split over the
ranks.

Bounds:

- against the port's replicated control (a float32 mean all-reduce per
  gradient), over two calls: bitwise at dp = 2, where every sum has two
  terms and so one order; at dp = 4 gloo's all-reduce and reduce-scatter
  sum four terms in other orders, so float32 losses are held to 1e-6
  relative and parameters to 1e-6 (a few ulps after 8 Adam steps at lr
  0.05; measured 1.1e-7 and 6e-8); bf16 parameters round the difference
  away and stay bitwise;
- an accumulation window of 2 against the accumulating control: stage 1
  bitwise; stages 2/3 fold float32 mean shards per micro step where the
  control sums the gradients in the parameters' dtype (the reference's
  tolerance-level case): losses 1e-5 relative in float32 and 5e-3 in bf16;
- the global-norm clip: the norm sums per-parameter sums of squares of
  each rank's part, so at dp = 2 the order differs from the control's:
  losses 1e-6 relative;
- the losses against the reference's ZeRO step (``_zero_enable`` on
  ``make_mesh({"dp": 2})``, the same weights and batches, float32): 1e-5
  relative, the same float32 math in another order. The reference runs
  its GSPMD form of the step, ``to_static(scan_steps=4)`` on the mesh
  without ``dp_axis``: its ``shard_map`` form passes ``check_rep``, which
  jax 0.9's ``shard_map`` no longer takes.
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
K_MAX = 4
BATCH = 16
LR = 0.05
BUCKET_MB = 1e-3
ARMS = [(1, True), (2, True), (3, True), (3, False)]  # (stage, prefetch)


def _inputs(path):
    """The reference MLP's weights and the batches, saved for the ranks."""
    import paddle_tpu as paddle
    paddle.seed(11)
    ref = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                               paddle.nn.Linear(32, 8))
    rng = np.random.RandomState(7)
    data = {f"w:{n}": np.asarray(t.numpy())
            for n, t in ref.state_dict().items()}
    data["x"] = rng.rand(K_MAX, BATCH, 16).astype("float32")
    data["y"] = rng.randint(0, 8, (K_MAX, BATCH)).astype("int64")
    np.savez(path, **data)
    return data


def spawn(workdir, world, task):
    """Run ``task`` on ``world`` gloo ranks; returns rank 0's result."""
    # a rank that aborts in native code prints torch's C++ stack and every
    # thread's Python stack (F11)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               TORCH_SHOW_CPP_STACKTRACES="1", PYTHONFAULTHANDLER="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(rank), str(world),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(Path(workdir) / f"{task}.pkl", "rb") as f:
        return pickle.load(f)


# -- the ranks ----------------------------------------------------------------

def _mlp(data, bf16):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.bridge import load_reference_state

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.add_sublayer("0", nn.Linear(16, 32, device="cpu"))
            self.add_sublayer("2", nn.Linear(32, 8, device="cpu"))

        def forward(self, x):
            first, second = self._modules["0"], self._modules["2"]
            x = x.to(first.weight.dtype)
            return second(torch.relu(first(x)))

    m = load_reference_state(MLP(), {n[2:]: v for n, v in data.items()
                                     if n.startswith("w:")})
    return m.to("bfloat16") if bf16 else m


def _build(data, stage, k, bf16, prefetch=None, accumulate=None, clip=None,
           probe=None):
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.nn import functional as F
    m = _mlp(data, bf16)
    opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR,
                          multi_precision=bf16, grad_clip=clip)
    if stage:
        opt._zero_enable(axis="dp", stage=stage, comm_buffer_mb=BUCKET_MB,
                         prefetch=prefetch)

    def one(xb, yb):
        loss = F.cross_entropy(m(xb).float(), yb)
        loss.backward()
        opt.step()
        if probe is not None:
            probe(m, opt)
        opt.clear_grad()
        return loss
    return (jit.to_static(one, scan_steps=k, dp_axis="dp",
                          accumulate_steps=accumulate), m, opt)


def _two_calls(data, k, **kw):
    step, m, opt = _build(data, k=k, **kw)
    x, y = (torch.from_numpy(data[n][:k]) for n in ("x", "y"))
    first = step(x, y)
    params = [p.detach().clone() for p in m.parameters()]
    return first, params, step(x, y), opt


def _diff(a, b):
    """(bitwise, max |loss diff| relative, max |param diff|) of two runs."""
    same = all(torch.equal(u, v) for u, v in zip(a[0:3:2], b[0:3:2]))
    same &= all(torch.equal(u, v) for u, v in zip(a[1], b[1]))
    rel = max(float(((u - v).abs() / v.abs()).max())
              for u, v in zip(a[0:3:2], b[0:3:2]))
    par = max(float((u.float() - v.float()).abs().max())
              for u, v in zip(a[1], b[1]))
    return same, rel, par


def _param_bytes(model, opt):
    """The bytes of parameters this rank holds: the storages the
    parameters are views of, each counted once, and stage 3's parameter
    shards. A storage is told apart by its identity (``_cdata``), not by
    its address: a released storage holds no memory, and whether its
    address reads as null or as a stale pointer that a live storage may
    reuse depends on the allocator and the build of torch."""
    held = {}
    for p in model.parameters():
        storage = p.untyped_storage()
        held[storage._cdata] = storage.nbytes()
    shards = opt._zero.stores_by_name() if opt._zero is not None else {}
    return sum(held.values()) + sum(
        t.numel() * t.element_size() for name, t in shards.items()
        if name.startswith("zero_param_"))


def _resident(data, stage, prefetch, bf16):
    """The parameter bytes held after each step of a call of two steps,
    and after the call, with the layout."""
    seen = []
    # the earlier arms' optimizers are reference cycles: collect them now,
    # not at a time of the collector's choosing inside the probed call
    gc.collect()
    step, m, opt = _build(data, stage, 2, bf16, prefetch=prefetch,
                          probe=lambda m, opt: seen.append(
                              _param_bytes(m, opt)))
    x, y = (torch.from_numpy(data[n][:2]) for n in ("x", "y"))
    step(x, y)
    return seen, _param_bytes(m, opt), opt.zero_layout()


RESIDENT = [(2, True), (3, True), (3, False)]


def _task_dp(data, world):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import collective
    out = {}
    ks = (1, 4) if world == 2 else (4,)
    arms = ARMS if world == 2 else [(3, True)]
    for bf16 in (False, True):
        for k in ks:
            ctrl = _two_calls(data, k, stage=0, bf16=bf16)
            for stage, prefetch in arms:
                run = _two_calls(data, k, stage=stage, bf16=bf16,
                                 prefetch=prefetch)
                out[("arm", stage, prefetch, k, bf16)] = _diff(run, ctrl)
                if not bf16 and k == 4 and prefetch:
                    out[("losses", stage)] = [t.numpy() for t in run[0:3:2]]
    for stage in (1, 2, 3):
        for bf16 in (False, True):
            out[("layout", stage, bf16)] = _build(
                data, stage, 4, bf16)[2].zero_layout()
    for stage, prefetch in RESIDENT:
        for bf16 in (False, True):
            out[("resident", stage, prefetch, bf16)] = _resident(
                data, stage, prefetch, bf16)
    if world == 4:
        return out
    out[("losses", 0)] = [t.numpy() for t in _two_calls(
        data, 4, stage=0, bf16=False)[0:3:2]]
    for bf16 in (False, True):
        ctrl = _two_calls(data, 4, stage=0, bf16=bf16, accumulate=2)
        for stage in (1, 2, 3):
            run = _two_calls(data, 4, stage=stage, bf16=bf16, accumulate=2)
            out[("accumulate", stage, bf16)] = _diff(run, ctrl)
    clip = nn.ClipGradByGlobalNorm(0.05)
    ctrl = _two_calls(data, 4, stage=0, bf16=False, clip=clip)
    for stage in (1, 2, 3):
        run = _two_calls(data, 4, stage=stage, bf16=False, clip=clip)
        out[("clip", stage)] = _diff(run, ctrl)
    # the collectives of one step: the second of two k=1 calls
    x, y = (torch.from_numpy(data[n][:1]) for n in ("x", "y"))
    for stage, prefetch in [(0, None)] + ARMS:
        step, _, opt = _build(data, stage, 1, False, prefetch=prefetch)
        step(x, y)
        collective.reset_counts()
        step(x, y)
        out[("counts", stage, prefetch)] = {
            kind: calls for kind, (calls, _) in collective.counts().items()}
    out["errors"] = _errors(data)
    return out


def _errors(data):
    """{case: (exception type, message)} of _zero_enable's validation."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import parallel_env

    def caught(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 -- the case under test
            return type(e).__name__, str(e)
        return None

    class NonElementwise(optimizer.AdamW):
        _zero_compatible = False

    def params():
        return _mlp(data, False).parameters()

    opt = optimizer.AdamW(parameters=params())
    opt._zero_enable(axis="dp", stage=1)
    shared = list(_mlp(data, False).parameters())
    optimizer.AdamW(parameters=shared)._zero_enable(axis="dp", stage=2)
    mesh = parallel_env.current_mesh()
    return {
        "same settings": opt._zero_enable(axis="dp", stage=1),
        "other stage": caught(lambda: opt._zero_enable(axis="dp", stage=2)),
        "other prefetch": caught(lambda: opt._zero_enable(prefetch=False)),
        "non-elementwise": caught(lambda: NonElementwise(
            parameters=params())._zero_enable(axis="dp")),
        "per-tensor clip": caught(lambda: optimizer.AdamW(
            parameters=params(), grad_clip=nn.ClipGradByNorm(1.0))
            ._zero_enable(axis="dp")),
        "value clip": caught(lambda: optimizer.AdamW(
            parameters=params(), grad_clip=nn.ClipGradByValue(1.0))
            ._zero_enable(axis="dp")),
        "no axis": caught(lambda: optimizer.AdamW(
            parameters=params())._zero_enable(axis="nope")),
        "stage 4": caught(lambda: optimizer.AdamW(
            parameters=params())._zero_enable(axis="dp", stage=4)),
        "laid out": caught(lambda: optimizer.AdamW(
            parameters=shared)._zero_enable(axis="dp")),
        "mesh of another size": caught(lambda: parallel_env.make_mesh(
            {"dp": mesh.size + 1})),
    }


def _rank_main(task, rank, world, workdir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.init_parallel_env(
        device="cpu", init_method=f"file://{workdir}/rendezvous_{task}",
        world_size=world, rank=rank)
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": world}))
    data = dict(np.load(Path(workdir) / "inputs.npz"))
    if task.startswith("dp"):
        out = _task_dp(data, world)
    else:
        from test_torch_recompute import rank_task
        out = rank_task(task, data)
    if rank == 0:
        with open(Path(workdir) / f"{task}.pkl", "wb") as f:
            pickle.dump(out, f)
    torch.distributed.barrier()
    # drops the mesh's groups too, so gloo's threads are joined here and
    # not at interpreter exit (F11)
    parallel_env.destroy_parallel_env()


# -- the tests ----------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    path = tmp_path_factory.mktemp("zero")
    _inputs(path / "inputs.npz")
    return path


@pytest.fixture(scope="module")
def dp2(workdir):
    return spawn(workdir, 2, "dp2")


@pytest.fixture(scope="module")
def dp4(workdir):
    return spawn(workdir, 4, "dp4")


@pytest.mark.parametrize("stage, prefetch", ARMS,
                         ids=[f"zero{s}-prefetch_{'on' if p else 'off'}"
                              for s, p in ARMS])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_master"])
def test_zero_bitwise_matches_replicated_control(dp2, stage, prefetch, k,
                                                 bf16):
    same, rel, par = dp2[("arm", stage, prefetch, k, bf16)]
    assert same, (rel, par)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_master"])
def test_zero3_at_dp4(dp4, bf16):
    same, rel, par = dp4[("arm", 3, True, 4, bf16)]
    if bf16:
        assert same, (rel, par)
    else:
        assert rel <= 1e-6 and par <= 1e-6, (rel, par)


@pytest.fixture(scope="module")
def reference_losses(workdir):
    """The reference's replicated and ZeRO-1/2/3 losses on make_mesh(
    {"dp": 2}) (two calls of 4 steps, float32, the GSPMD step) and its
    layouts."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import parallel_env
    data = dict(np.load(workdir / "inputs.npz"))
    saved = parallel_env.current_mesh()
    out = {}
    try:
        for degree in (2, 4):
            parallel_env.set_mesh(parallel_env.make_mesh({"dp": degree}))
            for stage in (0, 1, 2, 3):
                for bf16 in (False, True):
                    paddle.seed(11)
                    m = paddle.nn.Sequential(paddle.nn.Linear(16, 32),
                                             paddle.nn.ReLU(),
                                             paddle.nn.Linear(32, 8))
                    m.set_state_dict({n[2:]: v for n, v in data.items()
                                      if n.startswith("w:")})
                    if bf16:
                        m.to("bfloat16")
                    opt = paddle.optimizer.AdamW(
                        parameters=m.parameters(), learning_rate=LR,
                        multi_precision=bf16)
                    if stage:
                        opt._zero_enable(axis="dp", stage=stage,
                                         comm_buffer_mb=BUCKET_MB)
                        out[("layout", degree, stage, bf16)] = \
                            opt.zero_layout()
                    if degree != 2 or bf16:
                        continue

                    def one(xb, yb, m=m, opt=opt):
                        loss = paddle.nn.functional.cross_entropy(m(xb), yb)
                        loss.backward()
                        opt.step()
                        opt.clear_grad()
                        return loss
                    step = paddle.jit.to_static(one, scan_steps=K_MAX)
                    x, y = (paddle.to_tensor(data[n]) for n in ("x", "y"))
                    out[("losses", stage)] = [step(x, y).numpy()
                                              for _ in range(2)]
    finally:
        parallel_env.set_mesh(saved)
    return out


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_losses_match_the_reference_zero_step(dp2, reference_losses, stage):
    for got, want in zip(dp2[("losses", stage)],
                         reference_losses[("losses", stage)]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


LAYOUT_KEYS = ("bucket_rows", "shard_rows", "n_buckets", "state_bytes",
               "stage", "degree", "prefetch")


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_master"])
@pytest.mark.parametrize("degree", [2, 4])
def test_zero_layout_equals_the_reference(dp2, dp4, reference_losses, stage,
                                          bf16, degree):
    got = (dp2 if degree == 2 else dp4)[("layout", stage, bf16)]
    want = reference_losses[("layout", degree, stage, bf16)]
    for name in LAYOUT_KEYS:
        assert got[name] == want[name], name


@pytest.mark.parametrize("stage, prefetch", RESIDENT,
                         ids=[f"zero{s}-prefetch_{'on' if p else 'off'}"
                              for s, p in RESIDENT])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_master"])
@pytest.mark.parametrize("degree", [2, 4])
def test_stage3_holds_only_its_parameter_shards_between_steps(
        dp2, dp4, stage, prefetch, bf16, degree):
    """Between the steps of a call a rank holds its shards of the
    parameters (plus bucket 0's full buffer with prefetch, the reference's
    prefetch slot) at stage 3, and the full parameters at stage 2; after
    the call the full parameters, gathered to be read."""
    seen, after, layout = (dp2 if degree == 2 else dp4)[
        ("resident", stage, prefetch, bf16)]
    row = 1024 * (2 if bf16 else 4)
    full = sum(layout["bucket_rows"]) * row
    shards = sum(layout["shard_rows"]) * row
    if stage == 3:
        slot = layout["bucket_rows"][0] * row if prefetch else 0
        assert seen == [shards + slot] * 2
        assert after == full + shards
        assert seen[0] < full  # the point of stage 3
    else:
        assert seen == [full] * 2 and after == full


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_master"])
def test_accumulation_window_matches_the_accumulating_control(dp2, stage,
                                                              bf16):
    same, rel, par = dp2[("accumulate", stage, bf16)]
    if stage == 1:
        assert same, (rel, par)
    else:
        assert rel <= (5e-3 if bf16 else 1e-5), (rel, par)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_global_norm_clip_on_the_shards(dp2, stage):
    same, rel, par = dp2[("clip", stage)]
    assert rel <= 1e-6, (rel, par)


BUCKETS = 4  # one parameter a bucket at BUCKET_MB


@pytest.mark.parametrize("stage, prefetch, want", [
    # the replicated control: one all-reduce per gradient, one for the loss
    (0, None, {"all_reduce": 5}),
    (1, True, {"reduce_scatter": BUCKETS, "all_gather": BUCKETS,
               "all_reduce": 1}),
    (2, True, {"reduce_scatter": BUCKETS, "all_gather": BUCKETS,
               "all_reduce": 1}),
    # stage 3 with prefetch: buckets 1.. before the forward, bucket 0 at the
    # tail, and buckets 1.. again at the end of the call
    (3, True, {"reduce_scatter": BUCKETS, "all_gather": 2 * BUCKETS - 1,
               "all_reduce": 1}),
    (3, False, {"reduce_scatter": BUCKETS, "all_gather": 2 * BUCKETS,
                "all_reduce": 1})])
def test_collectives_of_one_step(dp2, stage, prefetch, want):
    assert dp2[("counts", stage, prefetch)] == want


@pytest.mark.parametrize("case, kind, match", [
    ("other stage", "RuntimeError", "already enabled"),
    ("other prefetch", "RuntimeError", "already enabled"),
    ("non-elementwise", "NotImplementedError", "non-elementwise"),
    ("per-tensor clip", "NotImplementedError", "per-parameter norms"),
    ("no axis", "ValueError", "no axis"),
    ("stage 4", "ValueError", "stage must be 1, 2 or 3"),
    ("laid out", "NotImplementedError", "already carries a ZeRO layout"),
    ("mesh of another size", "ValueError", "needs a process group of")])
def test_zero_enable_validation(dp2, case, kind, match):
    got = dp2["errors"][case]
    assert got is not None and got[0] == kind and match in got[1], got


def test_zero_enable_accepts_what_it_supports(dp2):
    errors = dp2["errors"]
    assert errors["same settings"] > 0  # enabling again alike is a no-op
    assert errors["value clip"] is None


# -- in this process: validation before any collective ------------------------

def test_reduce_scatter_rejects_mismatched_shapes():
    from paddle_tpu_torch import distributed as dist
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="identical per-rank shapes"):
        dist.reduce_scatter(t, [torch.zeros(4), torch.zeros(5)])
    with pytest.raises(ValueError, match="identical per-rank shapes"):
        dist.reduce_scatter(t, [torch.zeros(4),
                                torch.zeros(4, dtype=torch.int64)])
    with pytest.raises(ValueError, match="group size"):
        dist.reduce_scatter(t, [torch.zeros(4), torch.zeros(4)])


def test_reduce_op_validation():
    from paddle_tpu_torch import distributed as dist
    t = torch.ones(4)
    with pytest.raises(ValueError, match="unknown ReduceOp"):
        dist.all_reduce(t, op="bogus")
    with pytest.raises(ValueError, match="unknown ReduceOp"):
        dist.reduce_scatter(t, [t], op="bogus")
    with pytest.raises(NotImplementedError, match="not supported"):
        dist.reduce_scatter(t, [t], op=dist.ReduceOp.MAX)
    # a world of one: the identities, counted
    dist.collective.reset_counts()
    assert dist.all_reduce(t) is t and torch.equal(t, torch.ones(4))
    assert dist.collective.counts()["all_reduce"] == (1, 16)


def test_to_static_validation():
    from paddle_tpu_torch import jit
    with pytest.raises(ValueError, match="multiple of"):
        jit.to_static(lambda x: x, scan_steps=3, dp_axis="dp",
                      accumulate_steps=2)
    with pytest.raises(ValueError, match="scan step"):
        jit.to_static(lambda x: x, accumulate_steps=2)
    with pytest.raises(ValueError, match="scan step"):
        jit.to_static(lambda x: x, dp_axis="dp")
    assert jit.to_static(lambda x: x, scan_steps=2,
                         accumulate_steps=1)._accumulate_steps is None


def test_bucket_assignment_equals_the_reference():
    import paddle_tpu as paddle
    from paddle_tpu.distributed import bucketing as ref_bucketing
    from paddle_tpu_torch.distributed import bucketing
    shapes = [(768, 2304), (2304,), (30720, 768), (768,), (3072, 768),
              (768, 3072), (2,), (768, 768)]
    ref_params = [paddle.zeros(list(s)) for s in shapes]
    ours = [torch.zeros(s) for s in shapes]
    for cap, last in ((25.0, None), (9.0, None), (9.0, 1.0), (1e-3, None)):
        want = [[tuple(p.shape) for p in b] for b in
                ref_bucketing.bucket_params(ref_params, cap, last)]
        got = [[tuple(p.shape) for p in b]
               for b in bucketing.bucket_params(ours, cap, last)]
        assert got == want, cap
        assert [bucketing.bucket_nbytes(b) for b in bucketing.bucket_params(
            ours, cap, last)] == [ref_bucketing.bucket_nbytes(b) for b in
                                  ref_bucketing.bucket_params(ref_params,
                                                              cap, last)]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "tests"))
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
