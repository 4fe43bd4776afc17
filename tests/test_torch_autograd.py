"""The port's autograd entry points (``backward``, ``grad`` with
``retain_graph``, ``create_graph`` and ``allow_unused``, ``no_grad``,
``PyLayer``) against the reference's, on the CPU: every case of the
reference's ``tests/test_autograd.py``, each run in both packages on the
same seeded inputs, the gradients within ``RTOL`` (float32, the same
math). Where the port's graph is torch's, a case that reads the
reference's tape (``_tape_node``) reads torch's instead.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.core.tensor import Tensor as RefTensor

RTOL = 1e-5

rng = np.random.RandomState(3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def both(a, grad=False):
    """The same array as a reference and as a port tensor (CPU)."""
    return (paddle.to_tensor(a, stop_gradient=not grad),
            pt.to_tensor(a, place="cpu", stop_gradient=not grad))


def close(want, got, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.numpy()),
                               np.asarray(want.numpy()), rtol=rtol,
                               atol=1e-6)


def test_simple_backward():
    a = rng.rand(3, 3).astype("float32")
    for x in both(a, grad=True):
        (x * x).sum().backward()
    r, p = both(a, grad=True)
    (r * r).sum().backward()
    (p * p).sum().backward()
    close(r.grad, p.grad)
    np.testing.assert_allclose(p.grad.numpy(), 2 * a, rtol=1e-6)


def test_chain_and_accumulate():
    w_r = paddle.Parameter(np.ones((2, 2), np.float32))
    w_p = pt.Parameter(torch.ones(2, 2))
    x_r, x_p = both(np.ones((2, 2), np.float32))
    for _ in range(2):  # two backward passes accumulate
        paddle.ops.matmul(x_r, w_r).sum().backward()
        pt.ops.matmul(x_p, w_p).sum().backward()
    np.testing.assert_allclose(w_p.grad.numpy(), np.asarray(w_r.grad.numpy()))
    np.testing.assert_allclose(w_p.grad.numpy(), 4 * np.ones((2, 2)))
    w_p.clear_grad()
    assert w_p.grad is None


def test_stop_gradient_blocks():
    r, p = both(rng.rand(2, 2).astype("float32"), grad=True)
    assert p.detach().stop_gradient and r.detach().stop_gradient
    (p * 2).sum().backward()
    assert p.grad is not None


def test_no_grad_context():
    w = pt.Parameter(torch.ones(2))
    with pt.no_grad():
        y = (w * 3).sum()
    assert y.grad_fn is None and not y.requires_grad
    y2 = (w * 3).sum()
    assert y2.grad_fn is not None
    assert pt.autograd.no_grad is pt.no_grad

    @pt.no_grad()
    def f(v):
        return v * 2
    assert not f(w).requires_grad
    with pt.no_grad():
        with pt.enable_grad():
            assert (w * 2).requires_grad
    from paddle_tpu_torch.core import autograd
    assert autograd.grad_enabled()


def test_grad_api():
    a = np.array([2.0, 3.0], np.float32)
    out = []
    for pkg, x in zip((paddle, pt), both(a, grad=True)):
        y = (x ** 2).sum()
        (gx,) = pkg.grad([y], [x])
        assert x.grad is None  # grad must not touch .grad
        out.append(gx)
    close(*out)
    assert type(out[1]) is pt.Tensor and out[1].stop_gradient


def test_grad_unused():
    for pkg in (paddle, pt):
        x = both(np.ones(2, np.float32), grad=True)[pkg is pt]
        z = both(np.ones(2, np.float32), grad=True)[pkg is pt]
        y = (x * 2).sum()
        with pytest.raises(RuntimeError):
            pkg.grad([y], [z])
        gz = pkg.grad([y], [z], allow_unused=True)
        assert gz[0] is None


def test_multi_output_op_grad():
    a = rng.rand(4).astype("float32")
    for pkg, x in zip((paddle, pt), both(a, grad=True)):
        parts = pkg.ops.split(x, 2)
        (parts[0].sum() * 2 + parts[1].sum() * 3).backward()
        np.testing.assert_allclose(np.asarray(x.grad.numpy()), [2, 2, 3, 3])


def test_retain_graph():
    for x in both(np.array([1.0], np.float32), grad=True):
        loss = (x * 3).sum()
        loss.backward(retain_graph=True)
        loss.backward(retain_graph=False)
        np.testing.assert_allclose(np.asarray(x.grad.numpy()), [6.0])


def test_backward_without_retain_frees_the_graph():
    """The reference drops the forward closures; torch frees the saved
    tensors: walking the graph again raises in both."""
    x = pt.to_tensor(np.ones(3, np.float32), place="cpu",
                     stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError, match="second time"):
        y.backward()


def test_non_leaf_grad_retention():
    for x in both(np.ones(2, np.float32), grad=True):
        h = x * 2
        h.retain_grads()
        (h * 3).sum().backward()
        np.testing.assert_allclose(np.asarray(h.grad.numpy()), [3, 3])


def _double(pkg):
    class Double(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, factor=2.0):
            ctx.save_for_backward(x)
            ctx.factor = factor
            return x * factor

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor
            assert tuple(x.shape) == (2,)
            return grad * ctx.factor
    return Double


def test_pylayer():
    a = np.array([1.0, 2.0], np.float32)
    for pkg, x in zip((paddle, pt), both(a, grad=True)):
        y = _double(pkg).apply(x)
        y.sum().backward()
        np.testing.assert_allclose(np.asarray(x.grad.numpy()), [2, 2])
    x = pt.to_tensor(a, place="cpu", stop_gradient=False)
    y = _double(pt).apply(x, factor=3.0)
    assert type(y) is pt.Tensor
    (gx,) = pt.grad(y.sum(), [x])
    np.testing.assert_allclose(gx.numpy(), [3, 3])


def test_pylayer_two_outputs_and_a_non_tensor_argument():
    class Split(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.k = k
            return x[:k] * 2, x[k:] * 3

        @staticmethod
        def backward(ctx, ga, gb):
            return pt.concat([ga * 2, gb * 3])

    x = pt.to_tensor(np.ones(4, np.float32), place="cpu",
                     stop_gradient=False)
    a, b = Split.apply(x, 1)
    (a.sum() + b.sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), [2, 3, 3, 3])


def test_recompute():
    from paddle_tpu.distributed.fleet.utils import recompute as ref_recompute
    from paddle_tpu_torch.recompute import recompute as port_recompute

    a = rng.rand(2, 3).astype("float32")
    grads = []
    for pkg, recompute in ((paddle, ref_recompute), (pt, port_recompute)):
        w = pkg.Parameter(np.ones((3, 3), np.float32)) if pkg is paddle \
            else pt.Parameter(torch.ones(3, 3))
        x = both(a)[pkg is pt]

        def block(inp, w=w, pkg=pkg):
            return pkg.ops.matmul(inp, w).exp()

        out_ref = block(x)
        out_ref.sum().backward()
        g_ref = np.asarray(w.grad.numpy()).copy()
        w.clear_grad()
        out = recompute(block, x)
        np.testing.assert_allclose(np.asarray(out.numpy()),
                                   np.asarray(out_ref.numpy()), rtol=1e-6)
        out.sum().backward()
        np.testing.assert_allclose(np.asarray(w.grad.numpy()), g_ref,
                                   rtol=1e-5)
        grads.append(g_ref)
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL)


class TestCreateGraph:
    """grad(create_graph=True): differentiable gradients."""

    def test_second_order(self):
        a = np.array([2.0, 3.0], np.float32)
        for pkg, x in zip((paddle, pt), both(a, grad=True)):
            y = (x * x * x).sum()
            (g,) = pkg.grad(y, [x], create_graph=True)
            np.testing.assert_allclose(np.asarray(g.numpy()),
                                       3 * np.array([4.0, 9.0]))
            assert not g.stop_gradient
            (g2,) = pkg.grad(g.sum(), [x])
            np.testing.assert_allclose(np.asarray(g2.numpy()),
                                       6 * np.array([2.0, 3.0]))

    def test_gradient_penalty_backward(self):
        """d/dw of ||dy/dx||^2 flows through .backward() into w.grad."""
        for pkg in (paddle, pt):
            w = both(np.array([1.0, 2.0], np.float32), grad=True)[pkg is pt]
            x = both(np.array([3.0, 4.0], np.float32), grad=True)[pkg is pt]
            y = (w * x * x).sum()
            (gx,) = pkg.grad(y, [x], create_graph=True)  # 2 w x
            (gx * gx).sum().backward()  # sum 4 w^2 x^2 -> 8 w x^2
            np.testing.assert_allclose(
                np.asarray(w.grad.numpy()),
                8 * np.array([1.0, 2.0]) * np.array([9.0, 16.0]))

    def test_third_order(self):
        for pkg, x in zip((paddle, pt), both(np.array([2.0], np.float32),
                                             grad=True)):
            y = (x * x * x * x).sum()  # x^4
            (g1,) = pkg.grad(y, [x], create_graph=True)
            (g2,) = pkg.grad(g1.sum(), [x], create_graph=True)
            (g3,) = pkg.grad(g2.sum(), [x])
            np.testing.assert_allclose(np.asarray(g3.numpy()), [48.0])

    def test_create_graph_through_layers(self):
        """The reference's case, with the port's layer holding the
        reference's weights: the penalty's weight gradients agree."""
        paddle.seed(0)
        ref = paddle.nn.Linear(3, 1)
        port = pt.nn.Linear(3, 1, device="cpu")
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(np.asarray(
                ref.weight.numpy())))
            port.bias.copy_(torch.from_numpy(np.asarray(ref.bias.numpy())))
        a = np.random.RandomState(0).rand(2, 3).astype(np.float32)
        grads = []
        for pkg, lin in ((paddle, ref), (pt, port)):
            x = both(a, grad=True)[pkg is pt]
            y = pkg.tanh(lin(x)).sum() if pkg is paddle else \
                pt.nn.functional.tanh(lin(x)).sum()
            (gx,) = pkg.grad(y, [x], create_graph=True)
            (gx * gx).sum().backward()
            g = lin.weight._grad if pkg is paddle else lin.weight.grad
            assert g is not None and np.isfinite(np.asarray(g)).all()
            grads.append(np.asarray(g))
        np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-6)

    def test_create_graph_with_amp(self):
        """An op recorded under auto_cast replays in its recorded dtypes
        outside the scope; the gradients come back float32."""
        for pkg in (paddle, pt):
            x = both(np.random.RandomState(0).rand(2, 3).astype(np.float32),
                     grad=True)[pkg is pt]
            w = both(np.random.RandomState(1).rand(3, 2).astype(np.float32),
                     grad=True)[pkg is pt]
            with pkg.amp.auto_cast(enable=True, dtype="bfloat16"):
                y = pkg.matmul(x, w).sum()
            (gx,) = pkg.grad(y, [x], create_graph=True)
            assert str(gx.dtype).endswith("float32")
            (gw,) = pkg.grad((gx * gx).sum(), [w])
            assert np.isfinite(np.asarray(gw.numpy())).all()

    def test_create_graph_retain_false_frees(self):
        """``retain_graph=False`` frees the forward graph's saved tensors;
        the gradient's own graph (made by create_graph) stays usable in
        torch, where the reference's walks the freed forward graph again
        and raises (a deliberate difference: torch keeps the two graphs
        apart)."""
        x = pt.to_tensor(np.ones(3, np.float32), place="cpu",
                         stop_gradient=False)
        y = (x * x).sum()
        (g,) = pt.grad(y, [x], create_graph=True, retain_graph=False)
        np.testing.assert_allclose(g.numpy(), [2.0, 2.0, 2.0])
        with pytest.raises(RuntimeError, match="second time"):
            pt.grad(y, [x])
        (g2,) = pt.grad(g.sum(), [x])
        np.testing.assert_allclose(g2.numpy(), [2.0, 2.0, 2.0])
        xr = RefTensor(np.ones(3, np.float32), stop_gradient=False)
        (gr,) = paddle.grad((xr * xr).sum(), [xr], create_graph=True,
                            retain_graph=False)
        with pytest.raises(RuntimeError, match="freed"):
            paddle.grad(gr.sum(), [xr])


def test_gradient_penalty_through_a_conv_discriminator():
    """(||grad_x D(x)|| - 1)^2 through the port's Conv2D and Linear, its
    weight gradients against the reference's with the same weights."""
    r = np.random.RandomState(5)
    w1 = (0.3 * r.randn(4, 2, 3, 3)).astype(np.float32)
    b1 = (0.1 * r.randn(4)).astype(np.float32)
    w2 = (0.2 * r.randn(4 * 4 * 4, 1)).astype(np.float32)
    x = r.randn(2, 2, 6, 6).astype(np.float32)
    out = []
    for pkg in (paddle, pt):
        kw = {} if pkg is paddle else {"device": "cpu"}
        conv = pkg.nn.Conv2D(2, 4, 3, **kw)
        fc = pkg.nn.Linear(4 * 4 * 4, 1, bias_attr=False, **kw)
        conv.set_state_dict({"weight": w1, "bias": b1})
        fc.set_state_dict({"weight": w2})
        xt = both(x, grad=True)[pkg is pt]
        h = pkg.nn.functional.relu(conv(xt))
        d = fc(pkg.flatten(h, 1)).sum()
        (gx,) = pkg.grad(d, [xt], create_graph=True)
        norm = (gx * gx).sum(axis=[1, 2, 3]).sqrt()
        penalty = ((norm - 1.0) ** 2).mean()
        penalty.backward()
        get = (lambda p: p._grad) if pkg is paddle else (lambda p: p.grad)
        out.append([np.asarray(get(p)) for p in (conv.weight, conv.bias,
                                                  fc.weight)] +
                   [float(np.asarray(penalty.numpy()))])
    for a, b in zip(out[0], out[1]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
