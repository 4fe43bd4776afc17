"""Step checkpoints that cross between the packages: the reference
(``paddle_tpu``, JAX on the CPU) writes and the port
(``paddle_tpu_torch``) restores, and the reverse, on the same inputs made
from a numpy seed.

The model is the reference checkpoint tests' MLP (Linear(16, 32), ReLU,
Linear(32, 8), AdamW at lr 0.05, 1e-3 MB buckets: one parameter a bucket)
from the reference's weights; each side trains one call of 2 steps,
checkpoints with ``include_rng=False`` (a JAX key and torch's generators
cannot be carried across), and the other side restores into fresh objects
built from another seed. Forms: replicated AdamW (eager steps, one process;
float32, and bf16 parameters with float32 masters), ZeRO-1 and ZeRO-3
(the reference's GSPMD step, ``to_static(scan_steps=2)`` on its dp mesh
without ``dp_axis``, the form that runs on every jax this repo meets; the
port on gloo ranks at dp = 2 that this file spawns). ZeRO-3 re-lays the
stores out across the packages: the reference at its 8-device CPU mesh,
the port at dp = 2, in both directions.

Bounds:

- the restored state equals the writer's byte for byte: every parameter,
  moment and master, ``@step`` and ``@lr``;
- the restored side's next call against the writer's own next call: the
  losses within 1e-5 relative, the parameters within 1e-5 of their largest
  magnitude (the same float32 math in two libraries' summation orders);
- before any crossing, the reference's own resume of each form is bitwise
  (the reference side passes here);
- the GradScalers over four steps with an inf injected at the second:
  the scale and the good/bad counts equal, the parameters within 1e-5 of
  their largest magnitude;
- ``save``/``load`` files load in the other package with equal values.
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
K = 2
LR = 0.05
BUCKET_MB = 1e-3
REL = 1e-5
FORMS = {  # name: (ZeRO stage, the reference's mesh degree, bf16)
    "replicated": (0, None, False), "replicated_bf16": (0, None, True),
    "zero1": (1, 2, False), "zero3": (3, 8, False)}


def _data(path):
    """The reference's initial weights and the two calls' batches."""
    import paddle_tpu as paddle
    paddle.seed(11)
    ref = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                               paddle.nn.Linear(32, 8))
    rng = np.random.RandomState(5)
    data = {f"w:{n}": np.asarray(t.numpy())
            for n, t in ref.state_dict().items()}
    for call in (1, 2):
        data[f"x{call}"] = rng.rand(K, 16, 16).astype("float32")
        data[f"y{call}"] = rng.randint(0, 8, (K, 16)).astype("int64")
    np.savez(path, **data)
    return data


def _weights(data):
    return {n[2:]: v for n, v in data.items() if n.startswith("w:")}


def _same_bytes(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _close(got, want):
    """Max |diff| over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the reference ------------------------------------------------------------

def _ref_build(form, seed, data=None):
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.distributed import parallel_env
    stage, degree, bf16 = FORMS[form]
    parallel_env.set_mesh(None if not stage else parallel_env.make_mesh(
        {"dp": degree}, devices=jax.devices()[:degree]))
    paddle.seed(seed)
    m = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                             paddle.nn.Linear(32, 8))
    if data is not None:
        m.set_state_dict(_weights(data))
    if bf16:
        m.to("bfloat16")
    opt = paddle.optimizer.AdamW(parameters=m.parameters(), learning_rate=LR,
                                 multi_precision=bf16)
    if stage:
        opt._zero_enable(axis="dp", stage=stage, comm_buffer_mb=BUCKET_MB)

    def one(xb, yb):
        logits = m(xb.astype("bfloat16") if bf16 else xb)
        loss = paddle.nn.functional.cross_entropy(
            logits.astype("float32"), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    if stage:
        program = paddle.jit.to_static(one, scan_steps=K)

        def call(x, y):
            return np.asarray(program(paddle.to_tensor(x),
                                      paddle.to_tensor(y)).numpy())
    else:
        def call(x, y):
            return np.array([one(paddle.to_tensor(x[i]),
                                 paddle.to_tensor(y[i])).numpy()
                             for i in range(K)])
    return call, m, opt


def _ref_state(m, opt):
    out = {"@step": np.asarray(opt._step_count._value),
           "@lr": np.asarray(opt._lr.tensor._value)}
    for n, p in m.state_dict().items():
        out[n] = {"param": np.asarray(p._value)}
        for slot in ("moment1", "moment2", "master"):
            acc = opt._accumulators.get((slot, id(p)))
            if acc is not None:
                out[n][slot] = np.asarray(acc._value)
    return out


def _ref_mgr(root, m, opt):
    from paddle_tpu import checkpoint
    return checkpoint.CheckpointManager(str(root), include_rng=False) \
        .add_model(m).add_optimizer(opt)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt_parity")
    _data(path / "inputs.npz")
    return path


@pytest.fixture(scope="module")
def reference(workdir):
    """Per form: the reference's checkpoint after call 1 (written under
    ``workdir/ref_<form>``), its state there, its call 2 and the state
    after it; and its own resume of that checkpoint into fresh objects."""
    from paddle_tpu.distributed import parallel_env
    data = dict(np.load(workdir / "inputs.npz"))
    saved_mesh = parallel_env.current_mesh()
    out = {}
    try:
        for form in FORMS:
            call, m, opt = _ref_build(form, 11, data)
            call(data["x1"], data["y1"])
            _ref_mgr(workdir / f"ref_{form}", m, opt).save(1)
            state = _ref_state(m, opt)
            losses = call(data["x2"], data["y2"])
            after = _ref_state(m, opt)
            call, m, opt = _ref_build(form, 99)
            _ref_mgr(workdir / f"ref_{form}", m, opt).restore()
            own = call(data["x2"], data["y2"])
            own_after = _ref_state(m, opt)
            out[form] = {"state": state, "losses": losses, "after": after,
                         "own_resume_bitwise": (
                             _same_bytes(own, losses) and all(
                                 _same_bytes(own_after[n]["param"],
                                             after[n]["param"])
                                 for n in after if not n.startswith("@")))}
            del call, m, opt
            gc.collect()  # no sharded store outlives its mesh
    finally:
        parallel_env.set_mesh(saved_mesh)
    return out


# -- the port -----------------------------------------------------------------

def _port_build(form, seed, data=None):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import jit, nn, optimizer
    from paddle_tpu_torch.bridge import load_reference_state
    from paddle_tpu_torch.nn import functional as F
    stage, _, bf16 = FORMS[form]
    pt.seed(seed)

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.add_sublayer("0", nn.Linear(16, 32, device="cpu"))
            self.add_sublayer("2", nn.Linear(32, 8, device="cpu"))

        def forward(self, x):
            first, second = self._modules["0"], self._modules["2"]
            return second(torch.relu(first(x.to(first.weight.dtype))))

    m = MLP()
    if data is not None:
        load_reference_state(m, _weights(data))
    if bf16:
        m.to("bfloat16")
    opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR,
                          multi_precision=bf16)
    if stage:
        opt._zero_enable(axis="dp", stage=stage, comm_buffer_mb=BUCKET_MB)

    def one(xb, yb):
        loss = F.cross_entropy(m(xb).float(), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    if stage:
        program = jit.to_static(one, scan_steps=K, dp_axis="dp")

        def call(x, y):
            return program(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    else:
        def call(x, y):
            return np.array([one(torch.from_numpy(x[i]),
                                 torch.from_numpy(y[i])).detach().numpy()
                             for i in range(K)])
    return call, m, opt


def _port_state(m, opt):
    """The port's state as :func:`_ref_state` gives the reference's: every
    parameter, moment and master in full (ZeRO stores gathered from every
    rank and cut into their parameters), ``@step`` and ``@lr``."""
    from paddle_tpu_torch.checkpoint.state import to_numpy
    out = {"@step": to_numpy(opt._step_count),
           "@lr": to_numpy(opt._lr.tensor)}
    names = {}
    for n, p in m.state_dict(keep_vars=True).items():
        out[n] = {"param": to_numpy(p)}
        names[id(p)] = n
    zero = opt._zero
    if zero is None:
        for (slot, pid), t in opt._accumulators.items():
            out[names[pid]][slot] = to_numpy(t)
        return out
    for b in zero.buckets:
        for slot in ("moment1", "moment2", "master"):
            if slot in b.stores:
                full = torch.cat(zero.gather_shards(b.stores[slot]))
                for p, seg in zip(b.params, b.segments(full)):
                    out[names[id(p)]][slot] = to_numpy(seg)
    return out


def _port_mgr(root, m, opt):
    from paddle_tpu_torch import checkpoint
    return checkpoint.CheckpointManager(str(root), include_rng=False) \
        .add_model(m).add_optimizer(opt)


def _port_side(workdir, forms):
    """Per form: restore the reference's checkpoint (fresh objects, another
    seed) and run call 2; then write the port's own checkpoint of call 1
    from the reference's weights (``workdir/port_<form>``), with its state
    there and its call 2."""
    data = dict(np.load(Path(workdir) / "inputs.npz"))
    out = {}
    for form in forms:
        call, m, opt = _port_build(form, 99)
        _port_mgr(Path(workdir) / f"ref_{form}", m, opt).restore()
        restored = _port_state(m, opt)
        losses = call(data["x2"], data["y2"])
        rec = {"restored": restored, "losses": losses,
               "after": _port_state(m, opt)}
        call, m, opt = _port_build(form, 11, data)
        call(data["x1"], data["y1"])
        _port_mgr(Path(workdir) / f"port_{form}", m, opt).save(1)
        rec["written"] = _port_state(m, opt)
        rec["written_losses"] = call(data["x2"], data["y2"])
        rec["written_after"] = _port_state(m, opt)
        out[form] = rec
    return out


def _rank_main(rank, world, workdir):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import parallel_env
    parallel_env.init_parallel_env(
        device="cpu", init_method=f"file://{workdir}/rendezvous_parity",
        world_size=world, rank=rank)
    parallel_env.set_mesh(parallel_env.make_mesh({"dp": world}))
    out = _port_side(workdir, ["zero1", "zero3"])
    if rank == 0:
        with open(Path(workdir) / "port_dp2.pkl", "wb") as f:
            pickle.dump(out, f)
    torch.distributed.barrier()
    # drops the mesh's groups too, so gloo's threads are joined here and
    # not at interpreter exit (F11)
    parallel_env.destroy_parallel_env()


@pytest.fixture(scope="module")
def port(workdir, reference):
    """The port's side of every form: the replicated ones in this process,
    ZeRO on two gloo ranks."""
    torch.set_num_threads(2)
    out = _port_side(workdir, ["replicated", "replicated_bf16"])
    # a rank that aborts in native code prints torch's C++ stack and every
    # thread's Python stack (F11)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               TORCH_SHOW_CPP_STACKTRACES="1", PYTHONFAULTHANDLER="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), "2", str(workdir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with open(workdir / "port_dp2.pkl", "rb") as f:
        out.update(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def reference_restores_port(workdir, port):
    """Per form: the reference restores the port's checkpoint into fresh
    objects (ZeRO-3 at its 8-device mesh: another degree than the port's
    2) and runs call 2."""
    from paddle_tpu.distributed import parallel_env
    data = dict(np.load(workdir / "inputs.npz"))
    saved_mesh = parallel_env.current_mesh()
    out = {}
    try:
        for form in FORMS:
            call, m, opt = _ref_build(form, 99)
            _ref_mgr(workdir / f"port_{form}", m, opt).restore()
            restored = _ref_state(m, opt)
            losses = call(data["x2"], data["y2"])
            out[form] = {"restored": restored, "losses": losses,
                         "after": _ref_state(m, opt)}
            del call, m, opt
            gc.collect()
    finally:
        parallel_env.set_mesh(saved_mesh)
    return out


# -- the tests ----------------------------------------------------------------

def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for n, slots in want.items():
        if n.startswith("@"):
            assert _same_bytes(got[n], slots), n
            continue
        assert sorted(got[n]) == sorted(slots), n
        for slot, arr in slots.items():
            assert _same_bytes(got[n][slot], arr), (n, slot)


@pytest.mark.parametrize("form", list(FORMS))
def test_the_reference_resumes_its_own_checkpoint_bitwise(reference, form):
    """The reference side of every crossing passes here first."""
    assert reference[form]["own_resume_bitwise"]


@pytest.mark.parametrize("form", list(FORMS))
def test_port_restores_a_reference_checkpoint(reference, port, form):
    _assert_same_state(port[form]["restored"], reference[form]["state"])
    if FORMS[form][2]:
        return  # bf16: the byte check is the point; the libraries' bf16
        # matmuls round differently
    ref_losses = reference[form]["losses"]
    rel = float(np.abs(port[form]["losses"] - ref_losses).max()
                / np.abs(ref_losses).max())
    assert rel <= REL, rel
    for n, slots in reference[form]["after"].items():
        if not n.startswith("@"):
            assert _close(port[form]["after"][n]["param"],
                          slots["param"]) <= REL, n


@pytest.mark.parametrize("form", list(FORMS))
def test_reference_restores_a_port_checkpoint(port, reference_restores_port,
                                              form):
    got = reference_restores_port[form]
    _assert_same_state(got["restored"], port[form]["written"])
    if FORMS[form][2]:
        return
    want = port[form]["written_losses"]
    rel = float(np.abs(got["losses"] - want).max() / np.abs(want).max())
    assert rel <= REL, rel
    for n, slots in port[form]["written_after"].items():
        if not n.startswith("@"):
            assert _close(got["after"][n]["param"], slots["param"]) <= REL, n


def test_the_port_refuses_the_reference_random_state(workdir, reference):
    """A reference checkpoint saved with its RNG key: the port's restore
    with include_rng=True refuses it with the reason; without, it
    restores."""
    from paddle_tpu import checkpoint as ref_checkpoint
    from paddle_tpu_torch import checkpoint
    ref_checkpoint.CheckpointManager(str(workdir / "ref_rng")).save(1)
    with pytest.raises(checkpoint.StateMismatchError,
                       match="include_rng=False"):
        checkpoint.CheckpointManager(str(workdir / "ref_rng")).restore()
    assert checkpoint.CheckpointManager(
        str(workdir / "ref_rng"), include_rng=False).restore()["step"] == 1


def test_grad_scaler_against_the_reference():
    """Four eager float32 steps under GradScaler(init_loss_scaling=128,
    incr_every_n_steps=2, decr_every_n_nan_or_inf=1) with an inf injected
    into a gradient at the second: the same skipped step, scale and
    counts after every step; parameters within 1e-5."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.bridge import load_reference_state
    from paddle_tpu_torch.nn import functional as F
    data = _data_inline()
    kw = dict(init_loss_scaling=128.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    paddle.seed(11)
    ref = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.ReLU(),
                               paddle.nn.Linear(32, 8))
    ref_opt = paddle.optimizer.AdamW(parameters=ref.parameters(),
                                     learning_rate=LR)
    ref_sc = paddle.amp.GradScaler(**kw)
    call, m, opt = _port_build("replicated", 99)
    load_reference_state(m, {n: np.asarray(t.numpy())
                             for n, t in ref.state_dict().items()})
    opt = optimizer.AdamW(parameters=m.parameters(), learning_rate=LR)
    sc = amp.GradScaler(**kw)
    got, want = [], []
    for i in range(4):
        x, y = data["x"][i], data["y"][i]
        loss = paddle.nn.functional.cross_entropy(
            ref(paddle.to_tensor(x)), paddle.to_tensor(y))
        ref_sc.scale(loss).backward()
        first = next(iter(ref.parameters()))
        if i == 1:
            first._grad = first._grad.at[0, 0].set(jnp.inf)
        ref_sc.step(ref_opt)
        ref_opt.clear_grad()
        want.append((float(ref_sc._scale._value),
                     int(ref_sc._good_steps._value),
                     int(ref_sc._bad_steps._value)))
        sc.scale(F.cross_entropy(m(torch.from_numpy(x)),
                                 torch.from_numpy(y))).backward()
        if i == 1:
            m.parameters()[0].grad[0, 0] = float("inf")
        sc.step(opt)
        opt.clear_grad()
        got.append((sc.get_init_loss_scaling(), int(sc._good_steps),
                    int(sc._bad_steps)))
    assert got == want == [(128.0, 1, 0), (64.0, 0, 0), (64.0, 1, 0),
                           (128.0, 0, 0)]
    assert int(opt._step_count) == int(ref_opt._step_count._value) == 3
    for (n, t), p in zip(ref.state_dict().items(), m.parameters()):
        assert _close(p.detach().numpy(), np.asarray(t._value)) <= REL, n


def _data_inline():
    rng = np.random.RandomState(9)
    return {"x": rng.rand(4, 16, 16).astype("float32"),
            "y": rng.randint(0, 8, (4, 16)).astype("int64")}


def test_save_load_crosses_between_the_packages(tmp_path):
    import ml_dtypes
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    h = np.array([1.5, -2.25], dtype=ml_dtypes.bfloat16)
    paddle.save({"w": paddle.to_tensor(w), "n": [3, "x"]},
                str(tmp_path / "ref.pdparams"))
    got = pt.load(str(tmp_path / "ref.pdparams"), place="cpu")
    assert torch.equal(got["w"], torch.from_numpy(w)) and got["n"] == [3, "x"]
    pt.save({"w": torch.from_numpy(w), "h": torch.tensor(
        [1.5, -2.25], dtype=torch.bfloat16)}, str(tmp_path / "port.pdparams"))
    back = paddle.load(str(tmp_path / "port.pdparams"))
    assert _same_bytes(np.asarray(back["w"].numpy()), w)
    assert _same_bytes(np.asarray(back["h"].numpy()), h)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
