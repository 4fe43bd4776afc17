"""``SyncBatchNorm`` and ``SGD``/``Momentum`` under ZeRO at dp 2 over gloo,
against the reference, on the CPU.

Two ranks (processes that run this file as a script, a ``file://``
rendezvous under the test's temporary directory, ``destroy_parallel_env``
at the end) each take half of a global batch; the test process runs the
reference.

- ``SyncBatchNorm`` (NCHW and NHWC) over the two halves against the
  reference's ``BatchNorm`` on the whole batch, with a loss ``sum(y * c)``:
  the output and the input's gradient (the halves side by side), the
  weight and bias gradients (the two ranks' sums added: the dp mean of
  the optimizer makes them the global batch's) and each rank's running
  buffers, within 1e-5 of the largest reference element (float32; the
  port's variance is ``E[x^2] - E[x]^2`` over the all-reduced sums, the
  reference's the two-pass ``jnp.var``).
- The plain ``BatchNorm`` at dp 2 normalises each half by its own
  statistics: each rank's output equals the reference's ``BatchNorm`` on
  that half, within the same bound. The reference's manual-dp
  (``shard_map``) program computes this; its GSPMD program the global
  batch's, which the next case holds.
- A small ResNet (a stem, a residual block, a strided stage; BatchNorm
  after each convolution) at dp 2, converted with
  ``convert_sync_batchnorm``, through ``to_static(scan_steps=2,
  dp_axis="dp")``, two calls: ``SGD`` and ``Momentum`` (with
  ``L2Decay(1e-4)``) replicated and under ZeRO-1, 2 and 3. Each ZeRO arm
  bitwise the port's replicated control (sums of two terms have one
  order); each arm's losses within 1e-5 relative and parameters within
  1e-5 relative L2 of the reference's GSPMD step on ``make_mesh({"dp":
  2})`` from the same weights and batches (the reference's replicated
  step, and its ZeRO-3 ``Momentum``), whose losses equal its own
  single-device step's within 1e-6: there the batch statistics are the
  global batch's.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BN_TOL = 1e-5
LOSS_REL, PARAM_REL, GSPMD_REL = 1e-5, 1e-5, 1e-6
K, BATCH, SIZE, CLASSES = 2, 8, 12, 10
LR = 0.05
ARMS = [(opt, stage) for opt in ("SGD", "Momentum") for stage in range(4)]


def small_resnet(M, **kw):
    """A stem, one residual block and a strided stage, in package ``M``."""
    nn = M.nn

    class Block(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.conv1 = nn.Conv2D(c, c, 3, padding=1, bias_attr=False, **kw)
            self.bn1 = nn.BatchNorm2D(c, **kw)
            self.conv2 = nn.Conv2D(c, c, 3, padding=1, bias_attr=False, **kw)
            self.bn2 = nn.BatchNorm2D(c, **kw)
            self.relu = nn.ReLU()

        def forward(self, x):
            y = self.relu(self.bn1(self.conv1(x)))
            return self.relu(self.bn2(self.conv2(y)) + x)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = nn.Conv2D(3, 8, 3, padding=1, bias_attr=False, **kw)
            self.bn = nn.BatchNorm2D(8, **kw)
            self.block = Block(8)
            self.down = nn.Conv2D(8, 16, 3, stride=2, padding=1,
                                  bias_attr=False, **kw)
            self.bn_down = nn.BatchNorm2D(16, **kw)
            self.relu = nn.ReLU()
            self.pool = nn.AdaptiveAvgPool2D(1)
            self.fc = nn.Linear(16, CLASSES, **kw)

        def forward(self, x):
            x = self.block(self.relu(self.bn(self.stem(x))))
            x = self.pool(self.relu(self.bn_down(self.down(x))))
            return self.fc(x.reshape([x.shape[0], -1]))

    return Net()


def _inputs(path):
    import paddle_tpu as paddle
    paddle.seed(31)
    net = small_resnet(paddle)
    rng = np.random.RandomState(32)
    data = {f"w:{k}": np.asarray(v.numpy())
            for k, v in net.state_dict().items()}
    data["x"] = rng.rand(2, K, BATCH, 3, SIZE, SIZE).astype("float32")
    data["y"] = rng.randint(0, CLASSES, (2, K, BATCH)).astype("int64")
    data["bn_x"] = (rng.randn(BATCH, 4, 5, 6) * 2 + 1).astype("float32")
    data["bn_c"] = rng.randn(BATCH, 4, 5, 6).astype("float32")
    data["bn_w"] = rng.uniform(0.5, 1.5, 4).astype("float32")
    data["bn_b"] = rng.uniform(-0.5, 0.5, 4).astype("float32")
    np.savez(path, **data)
    return data


def spawn(workdir, world=2):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               PYTHONFAULTHANDLER="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = []
    for rank in range(world):
        with open(Path(workdir) / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the ranks ----------------------------------------------------------------

def _bn_case(data, rank, sync, data_format):
    from paddle_tpu_torch import nn
    half = BATCH // 2
    x = data["bn_x"][rank * half:(rank + 1) * half]
    c = data["bn_c"][rank * half:(rank + 1) * half]
    if data_format == "NHWC":
        x, c = x.transpose(0, 2, 3, 1), c.transpose(0, 2, 3, 1)
    bn = nn.BatchNorm2D(4, data_format=data_format, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["bn_w"]))
        bn.bias.copy_(torch.from_numpy(data["bn_b"]))
    if sync:
        bn = nn.SyncBatchNorm.convert_sync_batchnorm(bn)
    xt = torch.tensor(np.ascontiguousarray(x), requires_grad=True)
    y = bn(xt)
    (y * torch.from_numpy(np.ascontiguousarray(c))).sum().backward()
    out = [y.detach().numpy(), xt.grad.numpy(), bn.weight.grad.numpy(),
           bn.bias.grad.numpy(), bn._mean.numpy(), bn._variance.numpy()]
    if data_format == "NHWC":
        out[0], out[1] = (a.transpose(0, 3, 1, 2) for a in out[:2])
    return type(bn).__name__, out


def _arm(data, opt_name, stage):
    from paddle_tpu_torch import jit, nn, optimizer
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.bridge import load_reference_state
    net = load_reference_state(small_resnet(pt, device="cpu"),
                               {k[2:]: v for k, v in data.items()
                                if k.startswith("w:")})
    net = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    if opt_name == "SGD":
        opt = optimizer.SGD(learning_rate=LR, parameters=net.parameters())
    else:
        opt = optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                 parameters=net.parameters(),
                                 weight_decay=pt.L2Decay(1e-4))
    if stage:
        opt._zero_enable(axis="dp", stage=stage)

    def one(xb, yb):
        loss = nn.functional.cross_entropy(net(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    step = jit.to_static(one, scan_steps=K, dp_axis="dp")
    losses = [step(torch.from_numpy(data["x"][c]),
                   torch.from_numpy(data["y"][c])) for c in range(2)]
    return (torch.cat(losses).numpy(),
            {k: v.detach().numpy().copy() for k, v in
             net.state_dict().items()})


def _rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.init_parallel_env(
        device="cpu", init_method=f"file://{workdir}/rendezvous",
        world_size=world, rank=rank)
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": world}))
    data = dict(np.load(Path(workdir) / "inputs.npz"))
    out = {}
    for sync in (True, False):
        for fmt in ("NCHW", "NHWC"):
            out[("bn", sync, fmt)] = _bn_case(data, rank, sync, fmt)
    for opt_name, stage in ARMS:
        out[("arm", opt_name, stage)] = _arm(data, opt_name, stage)
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.barrier()
    parallel_env.destroy_parallel_env()


# -- the reference -------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    path = tmp_path_factory.mktemp("sync_bn")
    _inputs(path / "inputs.npz")
    return path


@pytest.fixture(scope="module")
def ranks(workdir):
    return spawn(workdir)


@pytest.fixture(scope="module")
def data(workdir):
    return dict(np.load(workdir / "inputs.npz"))


def _ref_bn(data, lo, hi):
    import paddle_tpu as paddle
    bn = paddle.nn.BatchNorm2D(4)
    bn.weight.set_value(data["bn_w"])
    bn.bias.set_value(data["bn_b"])
    x = paddle.to_tensor(data["bn_x"][lo:hi], stop_gradient=False)
    y = bn(x)
    (y * paddle.to_tensor(data["bn_c"][lo:hi])).sum().backward()
    return [np.asarray(a) for a in (
        y.numpy(), x.grad.numpy(), bn.weight.grad.numpy(),
        bn.bias.grad.numpy(), bn._mean.numpy(), bn._variance.numpy())]


def _close(got, want, tol=BN_TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_sync_batchnorm_equals_full_batch_batchnorm(ranks, data,
                                                    data_format):
    want = _ref_bn(data, 0, BATCH)
    (n0, r0), (n1, r1) = (r[("bn", True, data_format)] for r in ranks)
    assert n0 == n1 == "SyncBatchNorm"
    _close(np.concatenate([r0[0], r1[0]]), want[0])
    _close(np.concatenate([r0[1], r1[1]]), want[1])
    _close(r0[2] + r1[2], want[2])
    _close(r0[3] + r1[3], want[3])
    for r in (r0, r1):
        _close(r[4], want[4])
        _close(r[5], want[5])


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_plain_batchnorm_at_dp2_uses_each_halfs_statistics(ranks, data,
                                                           data_format):
    half = BATCH // 2
    for rank, r in enumerate(ranks):
        name, got = r[("bn", False, data_format)]
        assert name == "BatchNorm2D"
        want = _ref_bn(data, rank * half, (rank + 1) * half)
        for a, b in zip(got, want):
            _close(a, b)


@pytest.fixture(scope="module")
def reference_runs(data):
    """The reference's losses and parameters: its GSPMD step on
    make_mesh({"dp": 2}) (replicated, and ZeRO-3 Momentum) and its
    single-device step."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import parallel_env
    saved = parallel_env.current_mesh()
    out = {}
    try:
        for key, degree, opt_name, stage in (
                ("single", None, "SGD", 0), ("gspmd", 2, "SGD", 0),
                ("gspmd", 2, "Momentum", 0), ("gspmd", 2, "Momentum", 3)):
            parallel_env.set_mesh(None if degree is None else
                                  parallel_env.make_mesh({"dp": degree}))
            net = small_resnet(paddle)
            net.set_state_dict({k[2:]: v for k, v in data.items()
                                if k.startswith("w:")})
            if opt_name == "SGD":
                opt = paddle.optimizer.SGD(learning_rate=LR,
                                           parameters=net.parameters())
            else:
                opt = paddle.optimizer.Momentum(
                    learning_rate=LR, momentum=0.9,
                    parameters=net.parameters(),
                    weight_decay=paddle.L2Decay(1e-4))
            if stage:
                opt._zero_enable(axis="dp", stage=stage)

            def one(xb, yb, net=net, opt=opt):
                loss = paddle.nn.functional.cross_entropy(net(xb), yb)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            step = paddle.jit.to_static(one, scan_steps=K)
            losses = [np.asarray(step(paddle.to_tensor(data["x"][c]),
                                      paddle.to_tensor(data["y"][c]))
                                 .numpy()) for c in range(2)]
            out[(key, opt_name, stage)] = (
                np.concatenate(losses),
                {k: np.asarray(v.numpy())
                 for k, v in net.state_dict().items()})
    finally:
        parallel_env.set_mesh(saved)
    return out


def test_reference_gspmd_batchnorm_takes_the_global_batch(reference_runs):
    single = reference_runs[("single", "SGD", 0)][0]
    gspmd = reference_runs[("gspmd", "SGD", 0)][0]
    np.testing.assert_allclose(gspmd, single, rtol=GSPMD_REL, atol=0)


@pytest.mark.parametrize("opt_name, stage", [a for a in ARMS if a[1]],
                         ids=[f"{o}-zero{s}" for o, s in ARMS if s])
def test_zero_arm_is_bitwise_the_replicated_control(ranks, opt_name, stage):
    for r in ranks:
        losses, params = r[("arm", opt_name, stage)]
        want_losses, want_params = r[("arm", opt_name, 0)]
        np.testing.assert_array_equal(losses, want_losses)
        for k in want_params:
            np.testing.assert_array_equal(params[k], want_params[k])


@pytest.mark.parametrize("opt_name, stage", ARMS,
                         ids=[f"{o}-zero{s}" for o, s in ARMS])
def test_arm_matches_the_reference_gspmd_step(ranks, reference_runs,
                                              opt_name, stage):
    ref_stage = 3 if (opt_name, stage) == ("Momentum", 3) else 0
    want_losses, want_params = reference_runs[("gspmd", opt_name,
                                               ref_stage)]
    losses, params = ranks[0][("arm", opt_name, stage)]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_REL, atol=0)
    names = sorted(want_params)
    a = np.concatenate([params[k].ravel() for k in names])
    b = np.concatenate([want_params[k].ravel() for k in names])
    assert np.linalg.norm(a - b) <= PARAM_REL * np.linalg.norm(b)
    for k in names:  # every rank holds the same state
        np.testing.assert_array_equal(ranks[1][("arm", opt_name, stage)][1][k],
                                      params[k])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
