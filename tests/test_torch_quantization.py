"""``quantization`` against the reference: QAT of a small MLP, a small
conv net and a 2-layer GPT (channel-wise weights), both packages from the
same weights (``bridge``) on the same seeded batches through SGD steps:
the outputs, losses, every gradient and each layer's activation and output
scales after every step, the first call's path included; a bf16
``auto_cast`` case whose fake-quant output is float32 in both packages;
``PTQ`` with ``abs_max`` and ``percentile`` calibration, whose sidecar
records equal the reference's; the reference's own quantization cases
(``tests/test_quant_sparsity.py``) run on the port; the scales kept out of
``state_dict`` and their dtypes through ``to("bfloat16")``; a frozen
model served from its ``jit.save`` artifact.

Tolerances (float32): outputs, losses and scales within 1e-5 relative to
their largest element, gradients within 1e-4. Round-to-nearest turns a
last-bit difference of an input (another summation order) into a whole
quantization level for an element that sits on a level's midpoint; on
these seeded inputs none does, and the bounds would show one. The bf16
case: the two packages' first losses within 2e-2 relative (bf16 rounds in
other places). PTQ's weight scales exact (an abs-max of the same weights),
its activation scales within 1e-6 relative.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.quantization as RQ
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.quantization as TQ
from paddle_tpu_torch.bridge import load_reference_state

TOL, GRAD_TOL, SCALE_TOL = 1e-5, 1e-4, 1e-5
AMP_LOSS_REL, PTQ_ACT_REL = 2e-2, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import device
    saved = device._current
    torch.set_num_threads(2)
    device.set_device("cpu")
    yield
    device._current = saved


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy(), np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _copy_weights(ref, port):
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})


def _scales(model, mixin):
    return {name: (float(np.asarray(sub._act_scale)),
                   float(np.asarray(sub._out_scale)))
            for name, sub in model.named_sublayers()
            if isinstance(sub, mixin)}


class _MLP:
    @staticmethod
    def build(nn):
        return nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 3))

    @staticmethod
    def batch(rng):
        return rng.randn(8, 6).astype(np.float32), rng.randn(8, 3).astype(
            np.float32)

    @staticmethod
    def loss(F, out, y):
        return F.mse_loss(out, y)


class _Conv:
    @staticmethod
    def build(nn):
        return nn.Sequential(nn.Conv2D(2, 4, 3, padding=1, stride=2),
                             nn.ReLU(), nn.Flatten(), nn.Linear(4 * 4 * 4, 3))

    @staticmethod
    def batch(rng):
        return rng.randn(4, 2, 8, 8).astype(np.float32), rng.randn(
            4, 3).astype(np.float32)

    @staticmethod
    def loss(F, out, y):
        return F.mse_loss(out, y)


def _qat_run(case, weight_type, steps=3):
    """(reference, port) models after QAT, with what each step gave."""
    import paddle_tpu.nn.functional as RF
    import paddle_tpu_torch.nn.functional as TF
    paddle.seed(3)
    ref, port = case.build(rnn), case.build(tnn)
    _copy_weights(ref, port)
    RQ.ImperativeQuantAware(weight_quantize_type=weight_type).quantize(ref)
    TQ.ImperativeQuantAware(weight_quantize_type=weight_type).quantize(port)
    ropt = paddle.optimizer.SGD(learning_rate=0.05,
                                parameters=ref.parameters())
    topt = pt.optimizer.SGD(learning_rate=0.05, parameters=port.parameters())
    rng = np.random.RandomState(4)
    for step in range(steps):
        x, y = case.batch(rng)
        rout = ref(paddle.to_tensor(x))
        rloss = case.loss(RF, rout, paddle.to_tensor(y))
        rloss.backward()
        tout = port(torch.from_numpy(x))
        tloss = case.loss(TF, tout, torch.from_numpy(y))
        tloss.backward()
        what = f"step {step}"
        _close(_np(tout), _np(rout), TOL, f"{what} output")
        _close(_np(tloss), _np(rloss), TOL, f"{what} loss")
        rgrads = {n: _np(p.grad) for n, p in ref.named_parameters()}
        for n, p in port.named_parameters():
            _close(_np(p.grad), rgrads[n], GRAD_TOL, f"{what} d{n}")
        rs, ts = _scales(ref, RQ._QuantLayerMixin), _scales(
            port, TQ._QuantLayerMixin)
        assert set(ts) == set(rs)
        for n in rs:
            _close(ts[n], rs[n], SCALE_TOL, f"{what} {n} act/out scales")
        ropt.step()
        ropt.clear_grad()
        topt.step()
        topt.clear_grad()
    return ref, port


@pytest.mark.parametrize("weight_type", ["abs_max", "channel_wise_abs_max"])
@pytest.mark.parametrize("case", [_MLP, _Conv], ids=["mlp", "conv"])
def test_qat_matches_the_reference_step_by_step(case, weight_type):
    ref, port = _qat_run(case, weight_type)
    for (n, r), (m, t) in zip(ref.named_sublayers(), port.named_sublayers()):
        if isinstance(r, RQ._QuantLayerMixin):
            rec_r, rec_t = r.quant_scales(), t.quant_scales()
            assert set(rec_r) == set(rec_t) and n == m
            _close(rec_t["weight_scale"], rec_r["weight_scale"], SCALE_TOL,
                   f"{n} weight scales")


def _gpt_cfg(mod):
    return mod.GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                         num_heads=2, max_seq_len=16, hidden_dropout=0.0,
                         attention_dropout=0.0)


def test_qat_gpt_two_layers_matches_the_reference():
    from paddle_tpu.models import gpt as rgpt
    from paddle_tpu_torch.models import gpt as tgpt
    paddle.seed(4)
    ref = rgpt.GPTForCausalLM(_gpt_cfg(rgpt))
    port = tgpt.GPTForCausalLM(_gpt_cfg(tgpt))
    _copy_weights(ref, port)
    names = list(port.state_dict())
    for m in (RQ, TQ):
        m.ImperativeQuantAware(
            weight_quantize_type="channel_wise_abs_max").quantize(
                ref if m is RQ else port)
    assert list(port.state_dict()) == names  # the reference's names
    quantized = [n for n, s in port.named_sublayers()
                 if isinstance(s, TQ.QuantizedLinear)]
    assert len(quantized) == 8  # qkv, proj, fc1, fc2 a block
    ropt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=ref.parameters())
    topt = pt.optimizer.SGD(learning_rate=0.1, parameters=port.parameters())
    rng = np.random.RandomState(5)
    for step in range(3):
        ids = rng.randint(0, 64, (2, 16)).astype(np.int64)
        rloss = ref.loss(ref(paddle.to_tensor(ids)), paddle.to_tensor(ids))
        rloss.backward()
        tloss = port.loss(port(torch.from_numpy(ids)), torch.from_numpy(ids))
        tloss.backward()
        _close(_np(tloss), _np(rloss), TOL, f"step {step} loss")
        rgrads = {n: _np(p.grad) for n, p in ref.named_parameters()}
        for n, p in port.named_parameters():
            _close(_np(p.grad), rgrads[n], GRAD_TOL, f"step {step} d{n}")
        rs, ts = _scales(ref, RQ._QuantLayerMixin), _scales(
            port, TQ._QuantLayerMixin)
        for n in rs:
            _close(ts[n], rs[n], SCALE_TOL, f"step {step} {n} scales")
        for opt in (ropt, topt):
            opt.step()
            opt.clear_grad()
    # a quantized state_dict moves between the packages both ways
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})


def test_bf16_auto_cast_fake_quant_output_is_float32():
    import paddle_tpu.amp as ramp
    from paddle_tpu_torch import amp as tamp
    x = np.random.RandomState(6).randn(4, 8).astype(np.float32)
    rq = RQ.fake_quant(paddle.to_tensor(x).astype("bfloat16"), 2.0)
    tq = TQ.fake_quant(torch.from_numpy(x).bfloat16(), 2.0)
    assert str(rq.dtype).endswith("float32") and tq.dtype == torch.float32
    _close(_np(tq), _np(rq), 0.0, "bf16 fake_quant")
    paddle.seed(6)
    ref, port = _MLP.build(rnn), _MLP.build(tnn)
    _copy_weights(ref, port)
    RQ.ImperativeQuantAware().quantize(ref)
    TQ.ImperativeQuantAware().quantize(port)
    seen = []
    orig = TQ._quantize

    def spy(v, scale, bits):
        out = orig(v, scale, bits)
        seen.append((v.dtype, scale.dtype, out.dtype))
        return out

    TQ._quantize = spy
    try:
        with tamp.auto_cast(dtype="bfloat16"):
            tout = port(torch.from_numpy(x[:, :6]).bfloat16())
    finally:
        TQ._quantize = orig
    with ramp.auto_cast(dtype="bfloat16"):
        rout = ref(paddle.to_tensor(x[:, :6]).astype("bfloat16"))
    # the activation (bf16 x against the float32 scale) leaves float32
    assert (torch.bfloat16, torch.float32, torch.float32) in seen
    assert tout.dtype == torch.bfloat16
    _close(_np(tout), _np(rout), AMP_LOSS_REL, "bf16 outputs")


def _loader(seed, n, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("algo", ["abs_max", "percentile"])
def test_ptq_sidecar_matches_the_reference(algo, tmp_path):
    from paddle_tpu.jit.to_static import InputSpec as RSpec
    from paddle_tpu_torch.jit.to_static import InputSpec as TSpec
    paddle.seed(7)
    ref, port = _Conv.build(rnn), _Conv.build(tnn)
    _copy_weights(ref, port)
    batches = _loader(8, 3, (4, 2, 8, 8))
    kw = dict(algo=algo, percentile=0.99)
    RQ.PTQ(**kw).quantize(ref, [(paddle.to_tensor(b),) for b in batches])
    TQ.PTQ(**kw).quantize(port, [(torch.from_numpy(b),) for b in batches])
    RQ.ImperativeQuantAware.save_quantized_model(
        ref, str(tmp_path / "r"), input_spec=[RSpec([None, 2, 8, 8])])
    TQ.ImperativeQuantAware.save_quantized_model(
        port, str(tmp_path / "t"), input_spec=[TSpec([None, 2, 8, 8])])
    rrec = RQ.load_quant_scales(str(tmp_path / "r"))
    trec = TQ.load_quant_scales(str(tmp_path / "t"))
    assert set(trec) == set(rrec) == {"0", "3"}
    for name in rrec:
        r, t = rrec[name], trec[name]
        assert set(t) == set(r)
        for key in ("weight_bits", "activation_bits", "channel_wise"):
            assert t[key] == r[key]
        assert t["weight_scale"] == r["weight_scale"]
        _close(t["act_scale"], r["act_scale"], PTQ_ACT_REL, f"{name} act")
        _close(t["out_scale"], r["out_scale"], PTQ_ACT_REL, f"{name} out")
    assert trec == json.loads((tmp_path / "t.quant.json").read_text())


# -- the reference's own cases (tests/test_quant_sparsity.py) on the port ---

def test_fake_quant_forward_levels():
    x = pt.to_tensor(np.linspace(-1, 1, 11).astype(np.float32), place="cpu")
    q = TQ.fake_quant(x, scale=1.0, bits=8).numpy()
    np.testing.assert_allclose(q * 127, np.round(q * 127), atol=1e-4)
    np.testing.assert_allclose(q, x.numpy(), atol=1.0 / 127)
    _close(q, _np(RQ.fake_quant(paddle.to_tensor(x.numpy()), 1.0)), 0.0,
           "levels")


def test_fake_quant_ste_gradient():
    x = pt.to_tensor(np.array([0.3, 2.0, -0.5, -1.0], np.float32),
                     place="cpu", stop_gradient=False)
    TQ.fake_quant(x, scale=1.0, bits=8).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 0.0, 1.0, 1.0])


def test_imperative_qat_swaps_layers():
    class M(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = tnn.Linear(8, 8)
            self.inner = tnn.Sequential(tnn.Linear(8, 4), tnn.ReLU())
            self.conv = tnn.Conv2D(1, 2, 3)

        def forward(self, x):
            return self.inner(self.fc1(x))

    m = M()
    TQ.ImperativeQuantAware().quantize(m)
    assert isinstance(m.fc1, TQ.QuantizedLinear)
    assert isinstance(m.inner[0], TQ.QuantizedLinear)
    assert type(m.conv).__name__ == "QuantizedConv2D"
    out = m(pt.to_tensor(np.random.rand(2, 8).astype(np.float32),
                         place="cpu"))
    assert tuple(out.shape) == (2, 4)
    with pytest.raises(ValueError, match="weight_quantize_type"):
        TQ.ImperativeQuantAware(weight_quantize_type="hist")


def test_qat_output_close_to_float():
    pt.seed(0)
    lin = tnn.Linear(16, 16)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 16)
                         .astype(np.float32))
    ref = lin(x).detach().numpy()
    got = TQ.QuantizedLinear(lin)(x).detach().numpy()
    assert np.abs(got - ref).max() < 0.15 * np.abs(ref).max() + 0.05


def test_qat_trains():
    pt.seed(0)
    rng = np.random.RandomState(0)
    model = tnn.Sequential(tnn.Linear(4, 1))
    TQ.ImperativeQuantAware().quantize(model)
    opt = pt.optimizer.Adam(parameters=model.parameters(), learning_rate=0.05)
    w_true = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    first = None
    for _ in range(60):
        xb = rng.randn(32, 4).astype(np.float32)
        loss = pt.nn.functional.mse_loss(model(torch.from_numpy(xb)),
                                         torch.from_numpy(xb @ w_true))
        loss.backward()
        opt.step()
        opt.clear_grad()
        first = float(loss) if first is None else first
    assert float(loss) < first * 0.1


def test_ptq_absmax_freezes():
    pt.seed(0)
    model = tnn.Sequential(tnn.Linear(8, 8), tnn.ReLU(), tnn.Linear(8, 2))
    TQ.PTQ(algo="abs_max").quantize(
        model, [(torch.from_numpy(b),) for b in _loader(0, 4, (16, 8))])
    q0 = model[0]
    assert q0._frozen and q0._act_scale_initialized
    s = float(q0._act_scale)
    assert s > 0
    model(torch.from_numpy(np.random.randn(4, 8).astype(np.float32) * 100))
    assert float(q0._act_scale) == s


def test_ptq_percentile_calibration():
    model = tnn.Sequential(tnn.Linear(8, 4))
    TQ.PTQ(algo="percentile", percentile=0.99).quantize(
        model, [(torch.from_numpy(b),) for b in _loader(1, 4, (64, 8))])
    assert 2.0 < float(model[0]._act_scale) < 3.2


def test_channel_wise_weight_scales_beat_per_tensor():
    rng = np.random.RandomState(0)
    w = rng.randn(8, 4).astype(np.float32)
    w[:, 0] *= 100.0
    x = rng.rand(5, 8).astype(np.float32)

    def build(channel):
        m = tnn.Linear(8, 4)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w))
            m.bias.zero_()
        wrap = tnn.Sequential(m)
        TQ.ImperativeQuantAware(
            weight_quantize_type="channel_wise_abs_max" if channel
            else "abs_max").quantize(wrap)
        return wrap(torch.from_numpy(x)).detach().numpy()

    ref = x @ w
    err_t = np.abs(build(False) - ref)[:, 1:].mean()
    err_c = np.abs(build(True) - ref)[:, 1:].mean()
    assert err_c < err_t / 4


def test_quantized_embedding_swap_and_forward():
    m = tnn.Sequential(tnn.Embedding(16, 8))
    TQ.ImperativeQuantAware(quantizable_layer_type=("Embedding",)).quantize(m)
    assert isinstance(m[0], TQ.QuantizedEmbedding)
    out = m(torch.tensor([1, 5, 9]))
    assert tuple(out.shape) == (3, 8)


def test_output_scales_sidecar_and_served_artifact(tmp_path):
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.jit.to_static import InputSpec
    model = tnn.Sequential(tnn.Linear(4, 8), tnn.ReLU(), tnn.Linear(8, 2))
    q = TQ.ImperativeQuantAware()
    q.quantize(model)
    rng = np.random.RandomState(1)
    for _ in range(3):
        model(torch.from_numpy(rng.rand(2, 4).astype(np.float32)))
    prefix = str(tmp_path / "qmodel")
    q.save_quantized_model(model, prefix,
                           input_spec=[InputSpec([None, 4], "float32")])
    scales = TQ.load_quant_scales(prefix)
    assert len(scales) == 2
    for name, rec in scales.items():
        assert rec["act_scale"] > 0 and rec["out_scale"] > 0
        assert rec["weight_bits"] == 8
        assert rec == model[int(name)].quant_scales()
    x = rng.rand(3, 4).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    name = pred.get_input_names()[0]
    pred.get_input_handle(name).copy_from_cpu(x)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(got, want)


def test_scales_stay_out_of_state_dict_and_keep_their_dtypes():
    m = tnn.Sequential(tnn.Linear(4, 4))
    names = list(m.state_dict())
    TQ.ImperativeQuantAware().quantize(m)
    assert list(m.state_dict()) == names == ["0.weight", "0.bias"]
    m.to("bfloat16")
    q = m[0]
    assert q.weight.dtype == torch.bfloat16
    assert q._act_scale.dtype == torch.float64
    assert q._out_scale.dtype == torch.float32
    assert q._act_init.dtype == torch.bool


def test_ptq_resnet_serving_accuracy_delta(tmp_path):
    """The reference's bar (test_quant_sparsity.py's ResNet case): PTQ a
    ResNet, serve the saved artifact through the Predictor, the quantized
    predictions track the float model's."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.jit.to_static import InputSpec
    from paddle_tpu_torch.vision.models import resnet18
    pt.seed(7)
    imgs = np.random.RandomState(3).rand(8, 3, 32, 32).astype(np.float32)
    model = resnet18(num_classes=10)
    model.eval()
    with torch.no_grad():
        float_logits = model(torch.from_numpy(imgs)).numpy()
    calib = [(torch.from_numpy(imgs[i:i + 2]),) for i in range(0, 8, 2)]
    qmodel = TQ.PTQ(algo="abs_max").quantize(model, calib)
    prefix = str(tmp_path / "resnet_q")
    TQ.ImperativeQuantAware.save_quantized_model(
        qmodel, prefix, input_spec=[InputSpec([None, 3, 32, 32], "float32")])
    cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(imgs)
    pred.run()
    served = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    assert (served.argmax(-1) == float_logits.argmax(-1)).mean() >= 0.75
    rel = np.abs(served - float_logits).mean() / (
        np.abs(float_logits).mean() + 1e-6)
    assert rel < 0.5, rel
    with torch.no_grad():
        eager = qmodel(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(served, eager, rtol=0,
                               atol=TOL * np.abs(eager).max())
