"""ResNet training and serving on the CPU against the reference: ResNet-18
(10 classes, 32 x 32, batch 4, float32) from the reference's weights with
PaddleClas's recipe, ``Momentum(momentum=0.9)`` with ``L2Decay(1e-4)`` and
a ``PiecewiseDecay`` rate stepped after every step (boundaries [1, 2],
PaddleClas's values 0.1, 0.01 and 0.001 scaled by 4 / 256 to the batch, so
each step runs at another rate); SGD and
Nesterov momentum with bf16 parameters and float32 masters on LeNet; the
port's k-step program against its own eager steps; step checkpoints that
cross between the packages in both directions; ResNet-18 served through
``Engine.from_layer`` in eval mode.

Tolerances:

- three ResNet-18 steps against the reference's eager steps, each from
  the reference's state before it (a free run amplifies rounding: at this
  size the loss moves by 3.5 in one step, so a 9e-5 relative difference
  of the first update is 3e-4 of the next loss, and 1% two steps later):
  each loss within 1e-5 relative, each update of the parameters within
  1e-3 of its size (L2 over all of them; measured 9.3e-5), the velocities
  within 1e-3 relative L2, the running statistics within 1e-4;
- LeNet's three steps (rate 0.01): in float32 the losses within 1e-5
  relative, the parameters and velocities within 1e-5 relative L2 over all
  of them; with bf16 parameters and float32 masters, the losses, the
  masters' travel and the velocities within 2e-2 (bf16 rounds in other
  places on the two sides), and each bf16 parameter exactly its master
  cast;
- the port's k-step program against the same eager steps: bitwise
  (tolerance 0; on the CPU the program is a loop over the same body);
- a checkpoint crossing: the restored state equals the writer's byte for
  byte (parameters, running statistics, velocities, ``@step``, ``@lr``); the
  restored side's next step against the writer's next step: the loss
  within 1e-4 relative;
- serving: the float32 engine's rows against the model's own eval forward
  of each request within 1e-5 and against the reference's eval forward
  within 1e-4 relative L2; the bf16 pass within 5e-2 relative L2 of
  float32.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as PF
from paddle_tpu import checkpoint as ref_checkpoint
from paddle_tpu.vision import models as ref_models
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import checkpoint, jit, optimizer, serving
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.checkpoint.state import to_numpy
from paddle_tpu_torch.vision import models

# PaddleClas's rates (0.1, then / 10 at each boundary, for a batch of 256)
# scaled to the batch of 4 by the linear scaling rule its configs follow
BOUNDARIES, VALUES = [1, 2], [0.1 * 4 / 256, 0.01 * 4 / 256, 0.001 * 4 / 256]
MOMENTUM, DECAY = 0.9, 1e-4
BATCH, SIZE, STEPS = 4, 32, 3
LOSS_REL = 1e-5
UPDATE_REL = 1e-3
VELOCITY_REL = 1e-3
BUFFER_TOL = 1e-4
LENET_REL = 1e-5
BF16_REL = 2e-2
CROSS_LOSS_REL = 1e-5
SERVE_SELF_TOL, SERVE_REF_REL, SERVE_BF16_REL = 1e-5, 1e-4, 5e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(arrays):
    return np.concatenate([np.asarray(a, "float64").ravel() for a in arrays])


def _batches(n=STEPS + 1):
    rng = np.random.RandomState(1)
    return [(rng.randn(BATCH, 3, SIZE, SIZE).astype("float32"),
             rng.randint(0, 10, (BATCH,)).astype("int64")) for _ in range(n)]


# -- the two sides ------------------------------------------------------------

def _ref_objects(seed=0):
    paddle.seed(seed)
    model = ref_models.resnet18(num_classes=10)
    opt = paddle.optimizer.Momentum(
        learning_rate=paddle.optimizer.lr.PiecewiseDecay(BOUNDARIES, VALUES),
        momentum=MOMENTUM, parameters=model.parameters(),
        weight_decay=paddle.regularizer.L2Decay(DECAY))
    return model, opt


def _ref_step(model, opt, x, y):
    loss = PF.cross_entropy(model(paddle.to_tensor(x)), paddle.to_tensor(y))
    loss.backward()
    opt.step()
    opt.clear_grad()
    opt._lr.scheduler.step()
    return float(loss.numpy())


def _ref_state(model, opt):
    """Parameters and buffers by structured name, velocities by the
    parameter's structured name, ``@step`` and ``@lr``."""
    out = {n: np.asarray(t.numpy()) for n, t in model.state_dict().items()}
    for n, p in model.named_parameters():
        out[n + ".velocity"] = np.asarray(
            opt._accumulators[("velocity", id(p))]._value)
    out["@step"] = np.asarray(opt._step_count._value)
    out["@lr"] = np.asarray(opt._lr.tensor._value)
    return out


def _port_objects(weights, seed=0):
    pt.seed(seed)
    model = models.resnet18(num_classes=10, device="cpu")
    if weights is not None:
        load_reference_state(model, weights)
    opt = optimizer.Momentum(
        learning_rate=optimizer.lr.PiecewiseDecay(BOUNDARIES, VALUES),
        momentum=MOMENTUM, parameters=model.parameters(),
        weight_decay=pt.L2Decay(DECAY))
    return model, opt


def _port_one_step(model, opt):
    def one_step(x, y):
        loss = TF.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return one_step


def _port_step(model, opt, x, y):
    loss = _port_one_step(model, opt)(torch.from_numpy(x), torch.from_numpy(y))
    opt._lr.scheduler.step()
    return loss.item()


def _port_state(model, opt):
    out = {n: to_numpy(t) for n, t in model.state_dict().items()}
    for n, p in model.named_parameters():
        out[n + ".velocity"] = to_numpy(opt._get_accumulator("velocity", p))
    out["@step"] = to_numpy(opt._step_count)
    out["@lr"] = to_numpy(opt._lr.tensor)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' three steps from the reference's weights, each with a
    checkpoint after step 1 and its state there; the reference objects are
    kept for the crossing back."""
    root = tmp_path_factory.mktemp("resnet_ckpt")
    data = _batches()
    ref, ref_opt = _ref_objects()
    initial = {n: np.asarray(t.numpy()) for n, t in ref.state_dict().items()}
    port, port_opt = _port_objects(initial)
    out = {"data": data, "initial": initial, "root": root,
           "ref_objects": (ref, ref_opt)}
    for side, (model, opt, step, state, mgr) in {
            "ref": (ref, ref_opt, _ref_step, _ref_state,
                    ref_checkpoint.CheckpointManager),
            "port": (port, port_opt, _port_step, _port_state,
                     checkpoint.CheckpointManager)}.items():
        losses, before = [], []
        for i, (x, y) in enumerate(data[:STEPS]):
            before.append(state(model, opt))
            losses.append(step(model, opt, x, y))
            if i == 0:
                mgr(str(root / side), include_rng=False).add_model(
                    model).add_optimizer(opt).save(1)
                out[side + "_step1"] = state(model, opt)
        out[side] = {"losses": losses, "before": before,
                     "state": state(model, opt)}
    return out


# -- three steps ----------------------------------------------------------------

def _load_port_state(model, opt, state):
    """The port's objects set to a state as :func:`_ref_state` gives it,
    the scheduler at the step it holds."""
    load_reference_state(model, {n: state[n] for n in model.state_dict()})
    opt.set_state_dict({k: v for k, v in state.items()
                        if k.endswith(".velocity") or k == "@step"})
    opt._lr.scheduler.step(int(state["@step"]))
    assert opt._lr.tensor.item() == state["@lr"]


def test_each_of_three_momentum_steps_matches_the_reference(runs):
    """Each step from the reference's state before it (so that a step's
    rounding does not carry into the next one's inputs), at the three
    rates."""
    ref = runs["ref"]
    after = ref["before"][1:] + [ref["state"]]
    model, opt = _port_objects(None, seed=5)
    for k, (x, y) in enumerate(runs["data"][:STEPS]):
        start, want = ref["before"][k], after[k]
        _load_port_state(model, opt, start)
        loss = _port_step(model, opt, x, y)
        assert abs(loss - ref["losses"][k]) <= LOSS_REL * abs(
            ref["losses"][k]), k
        got = _port_state(model, opt)
        assert got["@step"] == want["@step"] == k + 1
        assert got["@lr"] == want["@lr"]
        params = [n for n in start if "." in n and not n.endswith(
            ("_mean", "_variance", ".velocity"))]
        update = _flat(want[n] - start[n] for n in params)
        diff = _flat(got[n] - want[n] for n in params)
        assert np.linalg.norm(diff) <= UPDATE_REL * np.linalg.norm(update), k
        vel = [n + ".velocity" for n in params]
        assert _rel(_flat(got[n] for n in vel),
                    _flat(want[n] for n in vel)) <= VELOCITY_REL, k
        for n in start:
            if n.endswith(("_mean", "_variance")):
                assert not np.array_equal(want[n], start[n]), n
                np.testing.assert_allclose(got[n], want[n], rtol=BUFFER_TOL,
                                           atol=BUFFER_TOL, err_msg=n)


def test_piecewise_decay_writes_its_rate_into_the_device_value():
    ref = paddle.optimizer.lr.PiecewiseDecay([2, 5], [1.0, 0.5, 0.1])
    port = optimizer.lr.PiecewiseDecay([2, 5], [1.0, 0.5, 0.1])
    opt = optimizer.Momentum(learning_rate=port, parameters=[
        torch.nn.Parameter(torch.zeros(2))])
    for _ in range(7):
        assert port.get_lr() == ref.get_lr() == port.last_lr
        assert opt._lr.tensor.item() == np.float32(port.last_lr)
        port.step()
        ref.step()
    assert port.state_dict() == ref.state_dict()


LENET_CASES = {  # name: (optimizer keywords, bf16 parameters)
    "sgd_l2": (dict(weight_decay=1e-3), False),
    "momentum_nesterov": (dict(momentum=0.9, use_nesterov=True), False),
    "momentum_bf16_masters": (dict(momentum=0.9, multi_precision=True), True),
}


@pytest.mark.parametrize("kind", sorted(LENET_CASES))
def test_lenet_steps_match_the_reference(kind):
    kw, bf16 = LENET_CASES[kind]
    rng = np.random.RandomState(4)
    data = [(rng.rand(8, 1, 28, 28).astype("float32"),
             rng.randint(0, 10, (8,)).astype("int64")) for _ in range(3)]
    paddle.seed(2)
    ref = ref_models.LeNet()
    port = load_reference_state(models.LeNet(device="cpu"), {
        n: np.asarray(t.numpy()) for n, t in ref.state_dict().items()})
    if bf16:
        ref.to("bfloat16")
        port.to("bfloat16")
    cls = "SGD" if kind.startswith("sgd") else "Momentum"
    ref_opt = getattr(paddle.optimizer, cls)(
        learning_rate=0.01, parameters=ref.parameters(), **kw)
    port_opt = getattr(optimizer, cls)(
        learning_rate=0.01, parameters=port.parameters(), **kw)
    loss_tol = BF16_REL if bf16 else LENET_REL
    names = [n for n, _ in port.named_parameters()]
    ref_params = dict(ref.named_parameters())
    slot = "master" if bf16 else None

    def values():
        got = [to_numpy(port_opt._get_accumulator(slot, p) if slot else p)
               for p in port.parameters()]
        want = [np.asarray((ref_opt._accumulators[(slot, id(ref_params[n]))]
                            if slot else ref_params[n])._value)
                for n in names]
        return _flat(got), _flat(want)

    start = values()[1]
    for x, y in data:
        xr = paddle.to_tensor(x)
        want = PF.cross_entropy(ref(xr.astype("bfloat16") if bf16 else xr)
                                .astype("float32"), paddle.to_tensor(y))
        want.backward()
        ref_opt.step()
        ref_opt.clear_grad()
        xp = torch.from_numpy(x)
        got = TF.cross_entropy(port(xp.bfloat16() if bf16 else xp).float(),
                               torch.from_numpy(y))
        got.backward()
        port_opt.step()
        port_opt.clear_grad()
        assert abs(got.item() - float(want.numpy())) <= loss_tol * abs(
            float(want.numpy()))
    got, want = values()
    if not bf16:
        assert _rel(got, want) <= LENET_REL
    else:
        assert _rel(got - start, want - start) <= BF16_REL
        for p in port.parameters():
            assert p.dtype == torch.bfloat16
            master = port_opt._get_accumulator("master", p)
            assert master.dtype == torch.float32
            assert torch.equal(p.detach(), master.to(torch.bfloat16))
    if cls == "Momentum":
        vel = [to_numpy(port_opt._get_accumulator("velocity", p))
               for p in port.parameters()]
        want_vel = [np.asarray(ref_opt._accumulators[
            ("velocity", id(ref_params[n]))]._value) for n in names]
        assert _rel(_flat(vel), _flat(want_vel)) <= (
            BF16_REL if bf16 else LENET_REL)


# -- the k-step program ----------------------------------------------------------

def test_k_step_program_is_bitwise_its_own_eager_steps(runs):
    data = runs["data"][:STEPS]
    eager, eager_opt = _port_objects(runs["initial"])
    program_model, program_opt = _port_objects(runs["initial"])
    want = [_port_one_step(eager, eager_opt)(torch.from_numpy(x),
                                              torch.from_numpy(y)).item()
            for x, y in data]
    program = jit.to_static(_port_one_step(program_model, program_opt),
                            scan_steps=STEPS)
    got = program(torch.from_numpy(np.stack([x for x, _ in data])),
                  torch.from_numpy(np.stack([y for _, y in data])))
    assert got.shape == (STEPS,) and got.tolist() == want
    a, b = _port_state(program_model, program_opt), \
        _port_state(eager, eager_opt)
    assert sorted(a) == sorted(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


# -- checkpoints that cross ------------------------------------------------------

def _assert_same_bytes(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(np.asarray(got[n]),
                                      np.asarray(want[n]), err_msg=n)


def test_port_restores_a_reference_checkpoint(runs):
    model, opt = _port_objects(None, seed=5)
    checkpoint.CheckpointManager(str(runs["root"] / "ref"),
                                 include_rng=False).add_model(
        model).add_optimizer(opt).restore()
    _assert_same_bytes(_port_state(model, opt), runs["ref_step1"])
    x, y = runs["data"][1]
    assert abs(_port_step(model, opt, x, y) - runs["ref"]["losses"][1]) \
        <= CROSS_LOSS_REL * abs(runs["ref"]["losses"][1])


def test_reference_restores_a_port_checkpoint(runs):
    model, opt = runs["ref_objects"]
    ref_checkpoint.CheckpointManager(str(runs["root"] / "port"),
                                     include_rng=False).add_model(
        model).add_optimizer(opt).restore()
    _assert_same_bytes(_ref_state(model, opt), runs["port_step1"])
    x, y = runs["data"][1]
    assert abs(_ref_step(model, opt, x, y) - runs["port"]["losses"][1]) \
        <= CROSS_LOSS_REL * abs(runs["port"]["losses"][1])


# -- serving -----------------------------------------------------------------------

def test_resnet_served_through_the_engine_in_eval_mode(runs):
    ref, _ = runs["ref_objects"]
    ref.set_state_dict(runs["initial"])
    port, _ = _port_objects(runs["initial"])
    rng = np.random.RandomState(9)
    requests = [rng.randn(rows, 3, SIZE, SIZE).astype("float32")
                for rows in (1, 3, 2, 4)]
    spec = [([None, 3, SIZE, SIZE], "float32")]
    with serving.Engine.from_layer(port, spec, bucket_ladder=(1, 4),
                                   device="cpu") as eng:
        got = [eng.submit(r) for r in requests]
        got = [f.result()[0] for f in got]
    with serving.Engine.from_layer(port, spec, bucket_ladder=(1, 4),
                                   passes=("bf16",), device="cpu") as eng16:
        got16 = [eng16.predict(r)[0] for r in requests]
    assert port.training  # the engine serves an eval-mode snapshot
    live = copy.deepcopy(port).eval()
    for r, out, out16 in zip(requests, got, got16):
        with torch.no_grad():
            own = live(torch.from_numpy(r)).numpy()
        ref.eval()
        want = ref(paddle.to_tensor(r)).numpy()
        ref.train()
        assert out.shape == (len(r), 10) and out.dtype == np.float32
        np.testing.assert_allclose(out, own, rtol=SERVE_SELF_TOL,
                                   atol=SERVE_SELF_TOL)
        assert _rel(out, want) <= SERVE_REF_REL
        assert out16.dtype == np.float32
        assert _rel(out16, out) <= SERVE_BF16_REL


def test_engine_warms_up_on_the_thread_that_serves():
    """torch keeps cuDNN's plans and autotuning results per thread: the
    load's warm-up forwards run on the thread that later serves."""
    import threading

    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))

        def forward(self, x):
            seen.append(threading.current_thread())
            return x * self.w

    with serving.Engine.from_layer(Probe(), [([None, 3], "float32")],
                                   bucket_ladder=(1, 2),
                                   device="cpu") as eng:
        assert len(seen) == 2 and eng.stats()["warmup_runs"] == 2
        eng.predict(np.ones((2, 3), "float32"))
    assert len(seen) == 3 and len(set(seen)) == 1
    assert seen[0] is not threading.current_thread()
