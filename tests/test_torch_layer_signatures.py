"""The port's ``Layer`` surface and ``ParamAttr`` against the reference
(two repaired faults: ``parameters()`` was a generator, so
``backbone.parameters() + head.parameters()`` raised, and ``weight_attr``/
``bias_attr`` were accepted and ignored).

- Every public callable of a ported module (the scope of
  ``test_torch_api_names.py``) and every function of ``vision.ops`` takes
  the reference's parameter names in the reference's order. The port may
  add the keywords of ``EXTRA`` anywhere (its device, torch's own
  ``Module`` keywords, a process group's address); the names of
  ``DIFFERENT`` differ on purpose, each for its stated reason.
- Weights made through ``ParamAttr`` (an initializer, ``trainable``, a
  name) equal the reference's exactly (constant and assigned initializers:
  the packages' random generators differ).
- One ``Momentum`` and one ``AdamW`` step over parameters with
  ``ParamAttr(learning_rate=0.5, regularizer=L2Decay(1e-2))`` beside
  parameters without one: the updated parameters within 1e-6 relative of
  the reference's (float32, the same math).
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.nn import initializer as RI
from paddle_tpu_torch.nn import initializer as TI
from test_torch_api_names import NOT_PORTED, _get, _in_scope, _spec_names

STEP_REL = 1e-6

# Keywords the port adds to the reference's signatures.
EXTRA = {
    "device",                                    # the port's device rule
    "recurse", "remove_duplicate", "persistent",  # torch.nn.Module's own
    "prepend", "with_kwargs", "mode", "destination", "prefix", "keep_vars",
    "name",                                      # a reference-style name
    "rank", "init_method", "world_size", "group",  # no cluster launcher
    "stage_id", "seg_method"}                    # a pipeline stage, built
# Names whose parameters differ on purpose.
DIFFERENT = {
    # torch.nn.Module.to(*args, **kwargs): devices too, and paddle dtype
    # names (``layer.to("bfloat16")``)
    ".to": "torch.nn.Module.to",
    # torch.nn.Module's forward placeholder of the base classes
    "paddle_tpu.nn.Layer.forward": "torch.nn.Module.forward",
    "paddle_tpu.nn.LayerList.forward": "torch.nn.Module.forward",
    # a Parameter keeps torch.Tensor's own methods (core.tensor's table of
    # deliberate differences; tests/test_torch_tensor.py)
    "paddle_tpu.Parameter.backward": "torch.Tensor.backward",
    "paddle_tpu.Parameter.norm": "torch.Tensor.norm",
    "paddle_tpu.Parameter.split": "torch.Tensor.split",
    "paddle_tpu.Parameter.unique": "torch.Tensor.unique",
    "paddle_tpu.Parameter.unique_consecutive":
        "torch.Tensor.unique_consecutive",
}


def _params(fn):
    return list(inspect.signature(fn).parameters)


def _different(name):
    return name in DIFFERENT or any(
        name.endswith(k) for k in DIFFERENT if k.startswith("."))


def _pairs():
    for name in _spec_names():
        if name in NOT_PORTED or not _in_scope(name):
            continue
        ref, port = _get("paddle_tpu", name), _get("paddle_tpu_torch", name)
        if callable(ref) and port is not None:
            yield name, ref, port
    from paddle_tpu.vision import ops as ref_ops
    from paddle_tpu_torch.vision import ops as port_ops
    for name in ref_ops.__all__:
        yield (f"paddle_tpu.vision.ops.{name}", getattr(ref_ops, name),
               getattr(port_ops, name))


def test_ported_signatures_take_the_reference_names():
    wrong, checked = [], 0
    for name, ref, port in _pairs():
        try:
            want, got = _params(ref), _params(port)
        except (TypeError, ValueError):
            continue  # a builtin without a signature
        checked += 1
        if _different(name):
            continue
        if [p for p in got if p not in EXTRA or p in want] != want:
            wrong.append((name, want, got))
    assert checked > 1000
    assert wrong == []


def test_the_imperative_surface_is_compared():
    """The callables of the imperative surface are among the compared
    pairs: the ops, autograd, Tensor and Parameter, the RNG state, the
    flags and the vision functionals."""
    names = {name for name, _, _ in _pairs()}
    for name in ("paddle_tpu.ops.sum", "paddle_tpu.ops.getitem",
                 "paddle_tpu.ops.unique_consecutive", "paddle_tpu.rand",
                 "paddle_tpu.grad", "paddle_tpu.no_grad",
                 "paddle_tpu.to_tensor", "paddle_tpu.Tensor",
                 "paddle_tpu.Tensor.backward", "paddle_tpu.Parameter",
                 "paddle_tpu.Parameter.set_value", "paddle_tpu.set_flags",
                 "paddle_tpu.get_rng_state", "paddle_tpu.linalg.norm",
                 "paddle_tpu.nn.functional.deformable_conv",
                 "paddle_tpu.nn.functional.grid_sample",
                 "paddle_tpu.nn.LocalResponseNorm"):
        assert name in names, name


def test_the_allow_list_names_only_real_differences():
    seen = set()
    for name, ref, port in _pairs():
        if _different(name):
            assert _params(ref) != _params(port), name
            seen.update(k for k in DIFFERENT
                        if name == k or (k.startswith(".")
                                         and name.endswith(k)))
    assert seen == set(DIFFERENT)


# -- parameters(), state_dict() and the rest of the Layer surface ---------------

class Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(3, 4, device="cpu")
        self.scale = self.create_parameter([4], device="cpu",
                                           default_initializer=TI.Constant(2.0))
        self.register_buffer("steps", torch.zeros(()), persistable=False)


def test_parameters_is_a_list_that_adds():
    a, b = tnn.Linear(2, 3, device="cpu"), Net()
    both = a.parameters() + b.parameters()
    assert isinstance(a.parameters(), list) and len(both) == 2 + 3
    assert b.parameters(include_sublayers=False) == [b.scale]
    assert b.parameters(recurse=False) == [b.scale]  # torch's keyword
    assert [n for n, _ in b.named_parameters(include_sublayers=False)] == \
        ["scale"]
    assert isinstance(b.named_parameters(), list)
    assert [p.param_name for p in b.parameters()] == ["scale", "fc.weight",
                                                      "fc.bias"]


def test_state_dict_takes_the_reference_keywords():
    net = Net()
    assert list(net.state_dict(structured_name_prefix="net")) == [
        "net.scale", "net.fc.weight", "net.fc.bias"]
    assert list(net.state_dict(include_sublayers=False)) == ["scale"]
    live = net.state_dict(keep_vars=True)  # torch's keywords still work
    assert live["scale"] is net.scale and "steps" not in live
    missing, unexpected = net.set_state_dict(
        {"scale": np.ones(4, np.float32), "other": np.zeros(1)},
        use_structured_name=True)
    assert missing == ["fc.weight", "fc.bias"] and unexpected == ["other"]
    assert torch.equal(net.scale, torch.ones(4))


def test_set_state_dict_by_parameter_names():
    lin = tnn.Linear(2, 2, weight_attr=pt.ParamAttr(name="w0"),
                     device="cpu")
    lin.set_state_dict({"w0": np.full((2, 2), 3.0, np.float32)},
                       use_structured_name=False)
    assert torch.equal(lin.weight, torch.full((2, 2), 3.0))


# -- ParamAttr: the reference's weights ------------------------------------------------

def _same(ref_layer, port_layer):
    ref = {n: np.asarray(t.numpy()) for n, t in ref_layer.state_dict().items()}
    port = {n: t.numpy() for n, t in port_layer.state_dict().items()}
    assert sorted(ref) == sorted(port)
    for n in ref:
        np.testing.assert_array_equal(port[n], ref[n], err_msg=n)


def test_weight_attr_gives_the_reference_weights():
    w = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    cases = [
        (lambda: rnn.Linear(4, 4, weight_attr=RI.Constant(0.5)),
         lambda: tnn.Linear(4, 4, weight_attr=TI.Constant(0.5),
                            device="cpu")),
        (lambda: rnn.Linear(3, 4, weight_attr=paddle.ParamAttr(
            initializer=RI.Assign(w)), bias_attr=RI.Constant(0.25)),
         lambda: tnn.Linear(3, 4, weight_attr=pt.ParamAttr(
             initializer=TI.Assign(w)), bias_attr=TI.Constant(0.25),
             device="cpu")),
        (lambda: rnn.Conv2D(2, 3, 3, weight_attr=RI.Constant(0.1),
                            bias_attr=False),
         lambda: tnn.Conv2D(2, 3, 3, weight_attr=TI.Constant(0.1),
                            bias_attr=False, device="cpu")),
        (lambda: rnn.Conv1D(2, 3, 3, bias_attr=RI.Constant(-1.0),
                            weight_attr=RI.Constant(0.3)),
         lambda: tnn.Conv1D(2, 3, 3, bias_attr=TI.Constant(-1.0),
                            weight_attr=TI.Constant(0.3), device="cpu")),
        (lambda: rnn.Embedding(5, 3, padding_idx=1,
                               weight_attr=RI.Constant(0.3)),
         lambda: tnn.Embedding(5, 3, padding_idx=1,
                               weight_attr=TI.Constant(0.3), device="cpu")),
        (lambda: rnn.LayerNorm(4, weight_attr=RI.Constant(2.0),
                               bias_attr=False),
         lambda: tnn.LayerNorm(4, weight_attr=TI.Constant(2.0),
                               bias_attr=False, device="cpu")),
        (lambda: rnn.BatchNorm2D(3, weight_attr=paddle.ParamAttr(
            initializer=RI.Constant(0.7),
            regularizer=paddle.regularizer.L2Decay(0.0)),
            bias_attr=RI.Constant(0.2)),
         lambda: tnn.BatchNorm2D(3, weight_attr=pt.ParamAttr(
             initializer=TI.Constant(0.7), regularizer=pt.L2Decay(0.0)),
             bias_attr=TI.Constant(0.2), device="cpu")),
    ]
    for make_ref, make_port in cases:
        _same(make_ref(), make_port())


def test_param_attr_trainable_name_and_attributes():
    lin = tnn.Linear(2, 2, weight_attr=pt.ParamAttr(
        name="w0", trainable=False, learning_rate=0.5, need_clip=False,
        regularizer=pt.L2Decay(0.1)), device="cpu")
    ref = rnn.Linear(2, 2, weight_attr=paddle.ParamAttr(
        name="w0", trainable=False, learning_rate=0.5, need_clip=False,
        regularizer=paddle.regularizer.L2Decay(0.1)))
    w = lin.weight
    assert not w.requires_grad and ref.weight.stop_gradient
    assert w.optimize_attr == ref.weight.optimize_attr == {
        "learning_rate": 0.5}
    assert w.need_clip is ref.weight.need_clip is False
    assert w.regularizer.coeff == ref.weight.regularizer.coeff == 0.1
    assert lin.parameters()[0].param_name == "w0" == ref.weight.name
    assert lin.bias.requires_grad and lin.bias.param_name == "bias"
    assert tnn.Layer().create_parameter([2], attr=False) is None
    with pytest.raises(TypeError):
        pt.ParamAttr._to_attr(3)


def test_sparse_embedding_raises_naming_its_item():
    """ROADMAP item 2 ported ``Embedding(sparse=True)``: its table gets a
    row gradient (``SelectedRows``) and no dense one; a table that is not
    a leaf cannot carry one and raises."""
    emb = tnn.Embedding(10, 4, sparse=True, device="cpu")
    emb(torch.tensor([[1, 2, 2]])).sum().backward()
    rows = emb.weight._sparse_grad
    assert emb.weight.grad is None and rows.height == 10
    assert rows.rows.tolist() == [1, 2, 10]
    with pytest.raises(ValueError, match="leaf table"):
        tnn.functional.embedding(torch.tensor([1]), emb.weight * 1.0,
                                 sparse=True)


# -- the optimizers read the per-parameter rate and regularizer --------------------

ATTR = dict(learning_rate=0.5, regularizer=(1e-2,))


def _attr(pkg_attr, l2):
    return pkg_attr(learning_rate=ATTR["learning_rate"],
                    regularizer=l2(*ATTR["regularizer"]))


def _ref_step(kind):
    w0 = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    x = np.linspace(-2, 3, 15, dtype=np.float32).reshape(5, 3)
    lin = rnn.Linear(3, 4, weight_attr=_attr(
        paddle.ParamAttr, paddle.regularizer.L2Decay))
    lin.set_state_dict({"weight": w0, "bias": np.full(4, 0.1, np.float32)})
    if kind == "momentum":
        opt = paddle.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=lin.parameters(),
            weight_decay=paddle.regularizer.L2Decay(1e-3))
    else:
        opt = paddle.optimizer.AdamW(learning_rate=0.1,
                                     parameters=lin.parameters(),
                                     weight_decay=0.05)
    for _ in range(2):
        y = lin(paddle.to_tensor(x))
        (y * y).mean().backward()
        opt.step()
        opt.clear_grad()
    return {n: np.asarray(t.numpy()) for n, t in lin.state_dict().items()}


def _port_step(kind):
    from paddle_tpu_torch import optimizer
    w0 = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    x = np.linspace(-2, 3, 15, dtype=np.float32).reshape(5, 3)
    lin = tnn.Linear(3, 4, weight_attr=_attr(pt.ParamAttr, pt.L2Decay),
                     device="cpu")
    lin.set_state_dict({"weight": w0, "bias": np.full(4, 0.1, np.float32)})
    if kind == "momentum":
        opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=lin.parameters(),
                                 weight_decay=pt.L2Decay(1e-3))
    else:
        opt = optimizer.AdamW(learning_rate=0.1, parameters=lin.parameters(),
                              weight_decay=0.05)
    for _ in range(2):
        y = lin(torch.from_numpy(x))
        (y * y).mean().backward()
        opt.step()
        opt.clear_grad()
    return {n: t.detach().numpy() for n, t in lin.state_dict().items()}


@pytest.mark.parametrize("kind", ["momentum", "adamw"])
def test_per_parameter_rate_and_regularizer_give_the_reference_step(kind):
    ref, port = _ref_step(kind), _port_step(kind)
    for n in ref:
        np.testing.assert_allclose(port[n], ref[n], rtol=STEP_REL, atol=0,
                                   err_msg=n)


def test_the_rate_factor_moves_the_parameter_by_half():
    """Without momentum or decay, a factor of 0.5 halves the step."""
    from paddle_tpu_torch import optimizer
    lin = tnn.Linear(2, 1, weight_attr=pt.ParamAttr(
        initializer=TI.Constant(1.0), learning_rate=0.5),
        bias_attr=TI.Constant(1.0), device="cpu")
    opt = optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    lin(torch.ones(1, 2)).sum().backward()
    opt.step()
    assert torch.allclose(lin.weight, torch.full((2, 1), 1 - 0.05))
    assert torch.allclose(lin.bias, torch.full((1,), 1 - 0.1))


def test_zero_refuses_a_per_parameter_rate_by_name():
    from paddle_tpu_torch import optimizer
    lin = tnn.Linear(2, 2, weight_attr=pt.ParamAttr(learning_rate=0.5),
                     device="cpu")
    opt = optimizer.AdamW(parameters=lin.parameters())
    with pytest.raises(NotImplementedError, match="weight.*learning_rate"):
        opt._zero_enable(stage=1)


def test_repeated_structured_names_keep_their_optimizer_state_apart():
    from paddle_tpu_torch import optimizer
    a, b = tnn.Linear(2, 2, device="cpu"), tnn.Linear(2, 2, device="cpu")
    opt = optimizer.Momentum(parameters=a.parameters() + b.parameters())
    keys = [k for k in opt.state_dict() if k.endswith(".velocity")]
    assert len(keys) == len(set(keys)) == 4
