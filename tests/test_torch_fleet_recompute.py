"""The fleet's recompute (``distributed.fleet.utils.recompute``:
``recompute`` and ``RecomputeFunction``) on the CPU, against
``paddle_tpu``'s on the same weights and inputs (float32, 1e-5 relative),
bitwise against the same block run plainly, and as one recorded op of a
``static.Program``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
from paddle_tpu.distributed import fleet as rfleet
import paddle_tpu_torch as pt
import paddle_tpu_torch.static as static
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.distributed import fleet

CPU = "cpu"
X = np.random.RandomState(0).rand(3, 8).astype(np.float32)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _blocks():
    ref.seed(2)
    rblock = ref.nn.Sequential(ref.nn.Linear(8, 8), ref.nn.Tanh(),
                               ref.nn.Linear(8, 4))
    state = {k: np.asarray(v.numpy()) for k, v in
             rblock.state_dict().items()}
    pblock = load_reference_state(pt.nn.Sequential(
        pt.nn.Linear(8, 8, device=CPU), pt.nn.Tanh(),
        pt.nn.Linear(8, 4, device=CPU)), state)
    return rblock, pblock


def _grads(block):
    return [p.grad.detach().clone() for p in block.parameters()]


@pytest.mark.parametrize("policy", ["full", "selective"])
def test_recompute_matches_plain_and_the_reference(policy):
    rblock, pblock = _blocks()
    x = torch.from_numpy(X).requires_grad_()
    out = fleet.recompute(pblock, x, policy=policy)
    out.sum().backward()
    got, gx = _grads(pblock), x.grad.clone()
    for p in pblock.parameters():
        p.grad = None
    x2 = torch.from_numpy(X).requires_grad_()
    pblock(x2).sum().backward()
    for a, b in zip(got, _grads(pblock)):
        assert torch.equal(a, b)
    assert torch.equal(gx, x2.grad)
    rx = ref.to_tensor(X, stop_gradient=False)
    rout = rfleet.recompute(rblock, rx)
    rout.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), rout.numpy(), rtol=1e-5)
    for a, p in zip(got, rblock.parameters()):
        np.testing.assert_allclose(a.numpy(), p.grad.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_recompute_function_legacy_form():
    _rblock, pblock = _blocks()
    x = torch.from_numpy(X).requires_grad_()
    out = fleet.utils.RecomputeFunction.apply(pblock, True, x)
    out.sum().backward()
    got, gx = _grads(pblock), x.grad.clone()
    for p in pblock.parameters():
        p.grad = None
    x2 = torch.from_numpy(X).requires_grad_()
    pblock(x2).sum().backward()
    for a, b in zip(got, _grads(pblock)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gx, x2.grad, rtol=1e-6, atol=1e-7)


def test_recompute_is_one_op_of_a_program():
    _rblock, pblock = _blocks()
    prog = static.Program()
    with static.program_guard(prog):
        x = static.data("x", [3, 8], "float32", device=CPU)
        out = fleet.recompute(pblock, x)
        loss = pt.mean(out)
    assert prog.op_names() == ["recompute", "mean"]
    (g,) = static.gradients(loss, [x])
    lv, gv = static.Executor(CPU).run(prog, feed={"x": X},
                                      fetch_list=[loss, g])
    xe = torch.from_numpy(X).requires_grad_()
    le = pblock(xe).mean()
    le.backward()
    assert float(lv) == float(le)
    np.testing.assert_array_equal(gv, xe.grad.numpy())
    assert pt.recompute.is_remat_replay(pt.recompute.remat_replay(
        lambda: None))
