"""ONNX export against the reference: both packages' ``.onnx`` files of the
same layer, with the same weights (``bridge``), are evaluated by a small
numpy evaluator of the emitted operator subset (:func:`run_onnx`, below;
it imports only numpy, so ``chip_smoke.py`` uses it too) and must compute
the layer's output.

Models: the reference's three test models (an MLP, a strided conv with
ReLU, softmax of tanh of a Linear), LeNet, and a small ResNet and a
LayerNorm-GELU block. Also ``read_model``'s fields, the wire format, a
``cumsum`` and GPT's flash operator raising by name, ``opset_version <
13`` refused, and shapes fixed at the traced sizes.

Tolerance: the evaluated file against the port's eager forward and
against the reference's file within 1e-5 relative to the output's largest
element plus 1e-6 absolute (float32; the evaluator's products and sums run
in another order than torch's kernels).
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.onnx import _proto as _wire

REL, ABS = 1e-5, 1e-6

# ---- the numpy evaluator ----------------------------------------------------

_NP_TYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
             7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def _signed(v):
    return v - (1 << 64) if v >= 1 << 63 else v


def _attrs(buf):
    name, value, ints, floats = None, None, [], []
    kind = None
    for f, _, v in _wire.parse_fields(buf):
        if f == 1:
            name = v.decode()
        elif f == 2:
            value = v
        elif f == 3:
            value = _signed(v)
        elif f == 4:
            value = v.decode()
        elif f == 7:
            floats.append(v)
        elif f == 8:
            ints.append(_signed(v))
        elif f == 20:
            kind = v
    if kind == _wire.A_INTS:
        value = ints
    elif kind == _wire.A_FLOATS:
        value = floats
    return name, value


def parse_onnx(path):
    """The whole model: {"inputs", "outputs", "initializers" {name:
    array}, "nodes" [(op, inputs, outputs, attrs)], "opset", "producer"}."""
    with open(path, "rb") as f:
        buf = f.read()
    model = {"inputs": [], "outputs": [], "initializers": {}, "nodes": []}
    for field, _, v in _wire.parse_fields(buf):
        if field == 2:
            model["producer"] = v.decode()
        elif field == 8:
            model["opset"] = dict((f, x) for f, _, x in
                                  _wire.parse_fields(v)).get(2)
        elif field != 7:
            continue
        for f2, _, v2 in _wire.parse_fields(v) if field == 7 else ():
            if f2 == 1:
                ins, outs, op, attrs = [], [], "", {}
                for f3, _, v3 in _wire.parse_fields(v2):
                    if f3 == 1:
                        ins.append(v3.decode())
                    elif f3 == 2:
                        outs.append(v3.decode())
                    elif f3 == 4:
                        op = v3.decode()
                    elif f3 == 5:
                        k, val = _attrs(v3)
                        attrs[k] = val
                model["nodes"].append((op, ins, outs, attrs))
            elif f2 == 5:
                dims, name, dt, raw = [], "", None, b""
                for f3, _, v3 in _wire.parse_fields(v2):
                    if f3 == 1:
                        dims.append(v3)
                    elif f3 == 2:
                        dt = v3
                    elif f3 == 8:
                        name = v3.decode()
                    elif f3 == 9:
                        raw = v3
                model["initializers"][name] = np.frombuffer(
                    raw, _NP_TYPES[dt]).reshape(dims).copy()
            elif f2 in (11, 12):
                key = "inputs" if f2 == 11 else "outputs"
                model[key].append(_wire.parse_fields(v2)[0][2].decode())
    return model


def _pads(x, pads, value):
    nd = len(pads) // 2
    width = [(0, 0)] * (x.ndim - nd) + list(zip(pads[:nd], pads[nd:]))
    return np.pad(x, width, constant_values=value)


def _windows(x, kernel, strides, dilations=None):
    """[N, C, *out, *kernel] views of ``x`` [N, C, *spatial]."""
    nd = len(kernel)
    dilations = dilations or [1] * nd
    out = [(x.shape[2 + i] - (kernel[i] - 1) * dilations[i] - 1)
           // strides[i] + 1 for i in range(nd)]
    shape = x.shape[:2] + tuple(out) + tuple(kernel)
    st = x.strides
    strides_ = st[:2] + tuple(st[2 + i] * strides[i] for i in range(nd)) \
        + tuple(st[2 + i] * dilations[i] for i in range(nd))
    return np.lib.stride_tricks.as_strided(x, shape, strides_)


def _conv(x, w, b, a):
    nd = w.ndim - 2
    x = _pads(x, a.get("pads", [0] * 2 * nd), 0)
    win = _windows(x, list(w.shape[2:]), a.get("strides", [1] * nd),
                   a.get("dilations", [1] * nd))
    g = a.get("group", 1)
    n, c = x.shape[:2]
    cg, og = c // g, w.shape[0] // g
    outs = []
    for i in range(g):
        part = win[:, i * cg:(i + 1) * cg]
        wi = w[i * og:(i + 1) * og]
        outs.append(np.einsum("nchwij,ocij->nohw", part.astype(np.float64),
                              wi.astype(np.float64)))
    out = np.concatenate(outs, axis=1)
    if b is not None:
        out = out + b.reshape(1, -1, *([1] * nd))
    return out.astype(x.dtype)


def _pool(x, a, kind):
    kernel = a["kernel_shape"]
    nd = len(kernel)
    pads = a.get("pads", [0] * 2 * nd)
    if a.get("ceil_mode", 0):
        raise NotImplementedError("ceil_mode")
    fill = -np.inf if kind == "max" else 0.0
    xp = _pads(x, pads, fill)
    win = _windows(xp, kernel, a.get("strides", [1] * nd))
    axes = tuple(range(-nd, 0))
    if kind == "max":
        return win.max(axis=axes)
    if a.get("count_include_pad", 0):
        return win.mean(axis=axes, dtype=np.float64).astype(x.dtype)
    ones = _windows(_pads(np.ones_like(x), pads, 0), kernel,
                    a.get("strides", [1] * nd))
    return (win.sum(axis=axes, dtype=np.float64)
            / ones.sum(axis=axes)).astype(x.dtype)


def _reduce(fn, ins, a):
    axes = (tuple(int(v) for v in ins[1]) if len(ins) > 1
            else tuple(a.get("axes", range(ins[0].ndim))))
    return fn(ins[0], axis=axes, keepdims=bool(a.get("keepdims", 1)))


_erf = np.vectorize(math.erf, otypes=[np.float64])

_OPS = {
    "Add": lambda i, a: i[0] + i[1], "Sub": lambda i, a: i[0] - i[1],
    "Mul": lambda i, a: i[0] * i[1], "Div": lambda i, a: i[0] / i[1],
    "Pow": lambda i, a: np.power(i[0], i[1]),
    "Max": lambda i, a: np.maximum(i[0], i[1]),
    "Min": lambda i, a: np.minimum(i[0], i[1]),
    "Neg": lambda i, a: -i[0], "Exp": lambda i, a: np.exp(i[0]),
    "Log": lambda i, a: np.log(i[0]), "Tanh": lambda i, a: np.tanh(i[0]),
    "Sigmoid": lambda i, a: 1 / (1 + np.exp(-i[0])),
    "Sqrt": lambda i, a: np.sqrt(i[0]), "Abs": lambda i, a: np.abs(i[0]),
    "Erf": lambda i, a: _erf(i[0]).astype(i[0].dtype),
    "Floor": lambda i, a: np.floor(i[0]), "Ceil": lambda i, a: np.ceil(i[0]),
    "Sign": lambda i, a: np.sign(i[0]), "Sin": lambda i, a: np.sin(i[0]),
    "Cos": lambda i, a: np.cos(i[0]), "Mod": lambda i, a: np.mod(i[0], i[1]),
    "Greater": lambda i, a: i[0] > i[1], "Less": lambda i, a: i[0] < i[1],
    "GreaterOrEqual": lambda i, a: i[0] >= i[1],
    "LessOrEqual": lambda i, a: i[0] <= i[1],
    "Equal": lambda i, a: i[0] == i[1], "Not": lambda i, a: ~i[0],
    "Where": lambda i, a: np.where(i[0], i[1], i[2]),
    "ReduceSum": lambda i, a: _reduce(np.sum, i, a),
    "ReduceMax": lambda i, a: _reduce(np.max, i, a),
    "ReduceMin": lambda i, a: _reduce(np.min, i, a),
    "ReduceProd": lambda i, a: _reduce(np.prod, i, a),
    "ArgMax": lambda i, a: (np.expand_dims if a.get("keepdims", 1)
                            else lambda v, ax: v)(
        np.argmax(i[0], axis=a.get("axis", 0)), a.get("axis", 0)),
    "ArgMin": lambda i, a: (np.expand_dims if a.get("keepdims", 1)
                            else lambda v, ax: v)(
        np.argmin(i[0], axis=a.get("axis", 0)), a.get("axis", 0)),
    "Cast": lambda i, a: i[0].astype(_NP_TYPES[a["to"]]),
    "MatMul": lambda i, a: np.matmul(i[0], i[1]),
    "Conv": lambda i, a: _conv(i[0], i[1], i[2] if len(i) > 2 else None, a),
    "MaxPool": lambda i, a: _pool(i[0], a, "max"),
    "AveragePool": lambda i, a: _pool(i[0], a, "avg"),
    "Gather": lambda i, a: np.take(i[0], i[1].astype(np.int64),
                                   axis=a.get("axis", 0)),
    "Reshape": lambda i, a: i[0].reshape([int(v) for v in i[1]]),
    "Transpose": lambda i, a: np.transpose(i[0], a.get("perm")),
    "Expand": lambda i, a: i[0] * np.ones([int(v) for v in i[1]],
                                          i[0].dtype),
    "Squeeze": lambda i, a: np.squeeze(i[0], tuple(int(v) for v in i[1])),
    "Concat": lambda i, a: np.concatenate(i, axis=a["axis"]),
    "Slice": lambda i, a: i[0][tuple(
        slice(None) if ax not in [int(v) for v in i[3]] else slice(
            int(i[1][list(i[3]).index(ax)]), int(i[2][list(i[3]).index(ax)]),
            int(i[4][list(i[3]).index(ax)]) if len(i) > 4 else 1)
        for ax in range(i[0].ndim))],
    "Pad": lambda i, a: _pads(i[0], [int(v) for v in i[1]],
                              i[2] if len(i) > 2 else 0),
    "Identity": lambda i, a: i[0],
}


def run_onnx(path, *inputs):
    """Evaluate the ``.onnx`` file at ``path`` on numpy ``inputs``; returns
    the outputs (numpy arrays) in the graph's order."""
    model = parse_onnx(path)
    env = dict(model["initializers"])
    env.update(zip(model["inputs"], inputs))
    for op, ins, outs, attrs in model["nodes"]:
        if op not in _OPS:
            raise NotImplementedError(f"the evaluator has no {op}")
        res = _OPS[op]([env[n] for n in ins], attrs)
        env[outs[0]] = np.asarray(res)
    return [env[n] for n in model["outputs"]]


# ---- the tests --------------------------------------------------------------


@pytest.fixture(autouse=True)
def _cpu():
    """Layers and data on the CPU (the package's default is the card)."""
    from paddle_tpu_torch.core import device
    saved = device._current
    torch.set_num_threads(2)
    device.set_device("cpu")
    yield
    device._current = saved


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale + ABS,
                               err_msg=what)


def _models(name):
    """(reference layer, port layer, input shape, input dtype) with the
    reference's weights in both."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as rnn
    import paddle_tpu.nn.functional as RF
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.nn.functional as TF
    from paddle_tpu.vision import models as rmodels
    from paddle_tpu_torch.bridge import load_reference_state
    from paddle_tpu_torch.vision import models as tmodels

    paddle.seed(5)

    class SmaxR(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = rnn.Linear(4, 4)

        def forward(self, x):
            return RF.softmax(RF.tanh(self.fc(x)), axis=-1)

    class SmaxT(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Linear(4, 4)

        def forward(self, x):
            return TF.softmax(TF.tanh(self.fc(x)), axis=-1)

    class NormR(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = rnn.LayerNorm(8)
            self.fc = rnn.Linear(8, 8)

        def forward(self, x):
            return RF.gelu(self.fc(self.ln(x)))

    class NormT(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = tnn.LayerNorm(8)
            self.fc = tnn.Linear(8, 8)

        def forward(self, x):
            return TF.gelu(self.fc(self.ln(x)))

    cases = {
        "mlp": (lambda m: m.Sequential(m.Linear(4, 8), m.ReLU(),
                                       m.Linear(8, 2)), [None, 4]),
        "conv": (lambda m: m.Sequential(m.Conv2D(3, 4, 3, padding=1,
                                                 stride=2), m.ReLU()),
                 [None, 3, 8, 8]),
        "softmax_tanh": ({rnn: SmaxR, tnn: SmaxT}, [None, 4]),
        "layer_norm_gelu": ({rnn: NormR, tnn: NormT}, [2, 8]),
        "lenet": ({rnn: rmodels.LeNet, tnn: tmodels.LeNet},
                  [None, 1, 28, 28]),
        "resnet18": ({rnn: lambda: rmodels.resnet18(num_classes=10),
                      tnn: lambda: tmodels.resnet18(num_classes=10)},
                     [1, 3, 32, 32]),
    }
    build, shape = cases[name]
    if isinstance(build, dict):
        ref, port = build[rnn](), build[tnn]()
    else:
        ref, port = build(rnn), build(tnn)
    ref.eval()
    port.eval()
    load_reference_state(port, {k: np.asarray(v.numpy()) for k, v in
                                ref.state_dict().items()})
    return ref, port, shape


MODELS = ["mlp", "conv", "softmax_tanh", "layer_norm_gelu", "lenet",
          "resnet18"]
# models whose reference file cannot be written: the primitive it lacks
REF_UNMAPPED = {"layer_norm_gelu": "square"}


@pytest.mark.parametrize("name", MODELS)
def test_both_files_compute_the_layer(name, tmp_path):
    """The port's file computes the port's forward and the reference's
    (the same weights); the reference's file computes the same. The
    reference's converter maps no ``square``, so its LayerNorm does not
    export (checked: it raises)."""
    import paddle_tpu as paddle
    from paddle_tpu import onnx as ronnx
    from paddle_tpu.jit.to_static import InputSpec as RSpec
    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec as TSpec

    ref, port, shape = _models(name)
    tpath = tonnx.export(port, str(tmp_path / "port"),
                         input_spec=[TSpec(shape, "float32", name="x")])
    fixed = [1 if d is None else d for d in shape]
    x = np.random.RandomState(3).randn(*fixed).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    (got,) = run_onnx(tpath, x)
    _close(got, want, f"{name}: the port's file against its forward")
    _close(got, np.asarray(ref(paddle.to_tensor(x)).numpy()),
           f"{name}: the port's file against the reference's forward")
    rspec = [RSpec(shape, "float32", name="x")]
    if name in REF_UNMAPPED:
        with pytest.raises(NotImplementedError, match=REF_UNMAPPED[name]):
            ronnx.export(ref, str(tmp_path / "ref"), input_spec=rspec)
        return
    (ref_got,) = run_onnx(ronnx.export(ref, str(tmp_path / "ref"),
                                       input_spec=rspec), x)
    _close(got, ref_got, f"{name}: the port's file against the reference's")


def test_read_model_fields_match_the_reference(tmp_path):
    from paddle_tpu import onnx as ronnx
    from paddle_tpu.jit.to_static import InputSpec as RSpec
    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec as TSpec

    ref, port, _ = _models("mlp")
    spec = [None, 4]
    rm = ronnx.read_model(ronnx.export(
        ref, str(tmp_path / "r"), input_spec=[RSpec(spec, "float32",
                                                    name="feat")]))
    tm = tonnx.read_model(tonnx.export(
        port, str(tmp_path / "t.onnx"), input_spec=[TSpec(spec, "float32",
                                                          name="feat")]))
    assert set(tm) == set(rm)
    assert tm["inputs"] == rm["inputs"] == ["feat"]
    assert len(tm["outputs"]) == len(rm["outputs"]) == 1
    assert tm["opset"] == rm["opset"] == 13
    assert tm["producer"] == "paddle_tpu_torch"
    ops = [n[0] for n in tm["nodes"]]
    assert ops.count("MatMul") == 2 and "Max" in ops  # relu = max(x, 0)
    dims = sorted(tuple(d) for _, d in tm["initializers"] if len(d) == 2)
    assert dims == sorted(tuple(d) for _, d in rm["initializers"]
                          if len(d) == 2) == [(4, 8), (8, 2)]
    assert (tmp_path / "t.onnx").exists()


def test_the_reference_op_checks_hold_for_the_port(tmp_path):
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec

    conv = tonnx.read_model(tonnx.export(
        tnn.Sequential(tnn.Conv2D(3, 4, 3, padding=1, stride=2), tnn.ReLU()),
        str(tmp_path / "conv"), input_spec=[InputSpec([None, 3, 8, 8])]))
    assert "Conv" in [n[0] for n in conv["nodes"]]
    _, port, _ = _models("softmax_tanh")
    ops = [n[0] for n in tonnx.read_model(tonnx.export(
        port, str(tmp_path / "smax"), input_spec=[InputSpec([None, 4])]))[
            "nodes"]]
    assert "Tanh" in ops and "Exp" in ops and "Div" in ops


def test_resnet50_has_its_53_convolutions(tmp_path):
    from collections import Counter

    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec
    from paddle_tpu_torch.vision.models import resnet50

    path = tonnx.export(resnet50(num_classes=10), str(tmp_path / "r50"),
                        input_spec=[InputSpec([None, 3, 32, 32])])
    kinds = Counter(n[0] for n in tonnx.read_model(path)["nodes"])
    assert kinds["Conv"] == 53 and kinds["MaxPool"] == 1
    assert kinds["MatMul"] == 1 and kinds["Max"] == 49  # the ReLUs


def test_unsupported_operator_is_loud(tmp_path):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec

    class Weird(tnn.Layer):
        def forward(self, x):
            return pt.ops.cumsum(x, axis=0)

    with pytest.raises(NotImplementedError, match="cumsum"):
        tonnx.export(Weird(), str(tmp_path / "weird"),
                     input_spec=[InputSpec([4], "float32")])
    assert not (tmp_path / "weird.onnx").exists()
    assert issubclass(tonnx.UnsupportedPrimitive, NotImplementedError)


def test_gpt_flash_operator_raises_by_name(tmp_path):
    """GPT at seq 1024 exports its attention as the package's flash
    operator (the custom op ``jit.save``'s artifacts hold), which has no
    ONNX mapping."""
    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=64, hidden_size=64, num_layers=1, num_heads=2,
                    max_seq_len=1024, hidden_dropout=0.0,
                    attention_dropout=0.0)
    with pytest.raises(tonnx.UnsupportedPrimitive,
                       match="paddle_tpu_torch::flash_attention_fwd"):
        tonnx.export(GPTForCausalLM(cfg), str(tmp_path / "gpt"),
                     input_spec=[InputSpec([None, 1024], "int64")])


def test_opset_below_13_and_missing_spec_refused(tmp_path):
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec

    m = tnn.Linear(3, 3)
    with pytest.raises(ValueError, match="opset_version 12"):
        tonnx.export(m, str(tmp_path / "m"), input_spec=[InputSpec([1, 3])],
                     opset_version=12)
    with pytest.raises(ValueError, match="input_spec"):
        tonnx.export(m, str(tmp_path / "m"))


def test_shapes_are_the_traced_ones_and_the_wire_format_parses(tmp_path):
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch import onnx as tonnx
    from paddle_tpu_torch.jit.to_static import InputSpec

    path = tonnx.export(tnn.Sequential(tnn.Linear(3, 3)), str(tmp_path / "p"),
                        input_spec=[InputSpec([None, 3], "float32")])
    with open(path, "rb") as f:
        fields = [f for f, _, _ in _wire.parse_fields(f.read())]
    assert {1, 7, 8} <= set(fields)  # ir_version, graph, opset_import
    x = np.ones((1, 3), np.float32)
    (out,) = run_onnx(path, x)
    assert out.shape == (1, 3)
