"""The LR schedulers (``optimizer.lr``) against the reference's, on the
CPU: every scheduler's rates over 30 steps equal the reference's (the same
host arithmetic in Python floats: exact), a ``step(epoch=)`` jump, the
state round trip, a bound optimizer's device rate, and a scheduler
stepped between calls of a k-step program (``jit.to_static(...,
scan_steps=k)``) against the same steps taken eagerly (bitwise)."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit, optimizer

STEPS = 30


def _plateau(lr):
    return lr.ReduceOnPlateau(0.5, factor=0.5, patience=2, cooldown=1,
                              threshold=0.01, min_lr=0.01)


SCHEDULERS = {  # name: maker(lr module)
    "NoamDecay": lambda lr: lr.NoamDecay(d_model=512, warmup_steps=4),
    "NoamDecay_scaled": lambda lr: lr.NoamDecay(64, 10, learning_rate=2.0),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.5, decay_steps=10,
                                                     end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(
        0.5, decay_steps=7, cycle=True),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.5, [3, 8, 20],
                                                   gamma=0.5),
    "StepDecay": lambda lr: lr.StepDecay(0.5, step_size=4, gamma=0.3),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "OneCycleLR": lambda lr: lr.OneCycleLR(1.0, total_steps=25),
    "OneCycleLR_linear": lambda lr: lr.OneCycleLR(
        0.1, total_steps=20, phase_pct=0.4, anneal_strategy="linear"),
    "ReduceOnPlateau": _plateau,
    "LinearWarmup_over_Noam": lambda lr: lr.LinearWarmup(
        lr.NoamDecay(128, 5), warmup_steps=3, start_lr=0.0, end_lr=0.01),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(0.5, 12),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([5, 9], [0.3, 0.1,
                                                            0.01]),
}

# a metric that improves, stalls and improves again (ReduceOnPlateau's)
METRICS = [1.0, 0.9, 0.85, 0.85, 0.86, 0.85, 0.849, 0.7, 0.7, 0.7, 0.71,
           0.7, 0.7, 0.69, 0.5] * 2


def _rates(sched):
    out = [sched.last_lr]
    for i in range(STEPS):
        if type(sched).__name__ == "ReduceOnPlateau":
            sched.step(METRICS[i])
        else:
            sched.step()
        out.append(sched.last_lr)
    return out


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_rates_equal_the_reference(case):
    want = _rates(SCHEDULERS[case](paddle.optimizer.lr))
    got = _rates(SCHEDULERS[case](optimizer.lr))
    assert got == want
    assert len(set(got)) > 1


@pytest.mark.parametrize("case", ["NoamDecay", "StepDecay",
                                  "PolynomialDecay_cycle"])
def test_epoch_jump_and_state_round_trip(case):
    ref = SCHEDULERS[case](paddle.optimizer.lr)
    port = SCHEDULERS[case](optimizer.lr)
    ref.step(epoch=17)
    port.step(epoch=17)
    assert port.last_lr == ref.last_lr and port.last_epoch == 17
    state = port.state_dict()
    assert state == ref.state_dict()
    fresh = SCHEDULERS[case](optimizer.lr)
    fresh.set_state_dict(state)
    fresh.step()
    port.step()
    assert fresh.last_lr == port.last_lr


def test_noam_decay_is_the_transformer_schedule():
    s = optimizer.lr.NoamDecay(d_model=512, warmup_steps=4000)
    rates = [s.last_lr] + [s.step() or s.last_lr for _ in range(8000)]
    peak = int(np.argmax(rates))
    assert peak == 4000
    assert rates[4000] == pytest.approx(512 ** -0.5 * 4000 ** -0.5)
    assert rates[0] == rates[1]  # the step is at least 1


def test_a_bound_optimizer_reads_each_new_rate_on_its_device():
    lin = tnn.Linear(2, 2, device="cpu")
    sched = optimizer.lr.ExponentialDecay(0.5, gamma=0.5)
    opt = optimizer.SGD(learning_rate=sched, parameters=lin.parameters())
    tensor = opt._lr.tensor
    for want in (0.5, 0.25, 0.125):
        assert opt.get_lr() == want and float(tensor) == want
        sched.step()
    assert opt._lr.tensor is tensor  # written in place, never rebound


@pytest.mark.parametrize("case", ["NoamDecay", "MultiStepDecay",
                                  "OneCycleLR"])
def test_stepped_between_calls_of_a_k_step_program(case):
    """Two calls of ``to_static(one_step, scan_steps=2)`` with the
    scheduler stepped between them: the parameters of 4 eager steps with
    the scheduler stepped after steps 2 and 4, bitwise."""
    r = np.random.RandomState(0)
    xs = torch.from_numpy(r.randn(4, 3, 2).astype(np.float32))
    ys = torch.from_numpy(r.randn(4, 3, 2).astype(np.float32))
    runs = []
    for program in (False, True):
        torch.manual_seed(0)
        lin = tnn.Linear(2, 2, device="cpu")
        with torch.no_grad():
            lin.weight.copy_(torch.eye(2))
            lin.bias.zero_()
        sched = SCHEDULERS[case](optimizer.lr)
        opt = optimizer.Adam(learning_rate=sched,
                             parameters=lin.parameters())

        def one_step(x, y):
            loss = ((lin(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        losses = []
        if program:
            step = jit.to_static(one_step, scan_steps=2)
            for call in range(2):
                losses += list(step(xs[2 * call:2 * call + 2],
                                    ys[2 * call:2 * call + 2]).detach())
                sched.step()
        else:
            for i in range(4):
                losses.append(one_step(xs[i], ys[i]).detach())
                if i % 2 == 1:
                    sched.step()
        runs.append((torch.stack(losses), lin.weight.detach().clone(),
                     sched.last_lr))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] and not math.isnan(runs[0][2])
