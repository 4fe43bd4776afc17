"""The Transformer layers against the reference's, on the CPU, with the
reference's weights (``bridge.load_reference_state``).

- ``MultiHeadAttention`` without a mask, with a boolean and an additive
  mask, with other key and value widths; its ``Cache`` grown a step at a
  time against the whole causal forward, its ``StaticCache``; outputs and
  gradients within ``RTOL``/``ATOL`` and ``GRAD_RTOL``/``GRAD_ATOL``
  (float32, the same math in another order).
- ``gen_cache``'s empty caches are float32 whatever the model's dtype, in
  both packages, and under bf16 ``auto_cast`` a step's grown cache is
  float32 in both (the concat promotes), its output within ``BF16_REL``.
- The encoder and decoder layers (post- and pre-norm, ReLU and GELU), the
  stacks and ``Transformer``; ``generate_square_subsequent_mask``
  exactly.
- At seq 1024 with no mask and dropout inactive the attention takes the
  flash kernels' Function, as the reference takes its Pallas kernel (on
  the CPU the reference writes it out, F3: held within ``FLASH_RTOL``);
  a mask or an active dropout writes it out.
- A tiny Transformer MT model (2 + 2 layers, d 32, 4 heads, vocab 50, a
  shared embedding scaled by sqrt(d), sinusoid positions, the output
  tied to the embedding, a padding mask and the causal mask, label
  smoothing 0.1 as ``label_smooth(one_hot(...))`` into a soft-label
  cross entropy with the padding weighted out) takes 3 steps of ``Adam``
  (0.9, 0.98, 1e-9) over ``NoamDecay``: the losses within ``MT_REL``
  relative, the parameters within ``MT_PARAM_SHARE`` of the rates' sum
  (Adam moves an element by up to its rate a step whatever the
  gradient's size, so an element whose gradient is rounding noise moves
  by a rounding-decided amount: measured 6e-5 of 0.088), all but the key
  projections' biases, whose gradient is exactly zero (softmax cancels a
  key bias), so Adam steps there on noise alone (they are held to twice
  the rates' sum, Adam's largest move); then beam search
  (beam 4) through ``BeamSearchDecoder`` and ``dynamic_decode`` over the
  decoder's (``Cache``, ``StaticCache``) states gives equal ids.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.bridge import load_reference_state
from paddle_tpu_torch.kernels import flash_attention as fa

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_REL = 2e-2
FLASH_RTOL = 1e-4
MT_REL, MT_PARAM_SHARE = 1e-5, 1e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy()).astype(np.float32)


def _state(layer):
    return {n: np.asarray(t.numpy()) for n, t in layer.state_dict().items()}


def _pair(build_ref, build_port):
    ref, port = build_ref(), build_port()
    load_reference_state(port, _state(ref))
    return ref, port


def _t(pkg, a, grad=False):
    if pkg is paddle:
        return paddle.to_tensor(a, stop_gradient=not grad)
    return pt.to_tensor(a, place="cpu", stop_gradient=not grad)


def _check_grads(ref, port, want, got, ref_ins, port_ins):
    c = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    wg = paddle.grad([(want * paddle.to_tensor(c)).sum()],
                     ref_ins + ref.parameters(), allow_unused=True)
    gg = pt.grad([(got * _t(pt, c)).sum()], port_ins + port.parameters(),
                 allow_unused=True)
    for i, (w, g) in enumerate(zip(wg, gg)):
        if w is None or g is None:
            other = g if w is None else w
            assert other is None or not np.any(_np(other)), i
            continue
        np.testing.assert_allclose(_np(g), _np(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=str(i))


MHA_CASES = {  # name: (constructor keywords, mask kind)
    "self": ({}, None),
    "bool_mask": ({}, "bool"),
    "additive_mask": ({}, "additive"),
    "kdim_vdim": ({"kdim": 6, "vdim": 5}, "additive"),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_multi_head_attention_matches_reference(case):
    kw, mask = MHA_CASES[case]
    ref, port = _pair(lambda: rnn.MultiHeadAttention(16, 4, **kw),
                      lambda: tnn.MultiHeadAttention(16, 4, device="cpu",
                                                     **kw))
    r = np.random.RandomState(sum(map(ord, case)))
    q = r.randn(2, 5, 16).astype(np.float32)
    k = r.randn(2, 7, kw.get("kdim", 16)).astype(np.float32)
    v = r.randn(2, 7, kw.get("vdim", 16)).astype(np.float32)
    m = None
    if mask == "bool":
        m = r.rand(2, 1, 5, 7) > 0.3
        m[..., 0] = True
    elif mask == "additive":
        m = np.where(r.rand(2, 1, 1, 7) > 0.3, 0.0, -1e9).astype(np.float32)
    outs, ins = [], []
    for pkg, layer in ((paddle, ref), (pt, port)):
        ts = [_t(pkg, a, True) for a in (q, k, v)]
        mt = None if m is None else _t(pkg, m)
        outs.append(layer(*ts, attn_mask=mt))
        ins.append(ts)
    np.testing.assert_allclose(_np(outs[1]), _np(outs[0]), rtol=RTOL,
                               atol=ATOL)
    _check_grads(ref, port, outs[0], outs[1], ins[0], ins[1])


def test_incremental_cache_matches_the_causal_forward_and_the_reference():
    ref, port = _pair(lambda: rnn.MultiHeadAttention(16, 4),
                      lambda: tnn.MultiHeadAttention(16, 4, device="cpu"))
    x = np.random.RandomState(2).randn(2, 6, 16).astype(np.float32)
    causal = tnn.Transformer.generate_square_subsequent_mask(6, device="cpu")
    whole = port(torch.from_numpy(x), attn_mask=pt.core.tensor.unwrap(
        causal))
    for pkg, layer in ((paddle, ref), (pt, port)):
        cache = layer.gen_cache(_t(pkg, x))
        assert tuple(cache.k.shape) == (2, 0, 4, 4)
        assert "float32" in str(cache.k.dtype)
        steps = []
        for i in range(6):
            xi = _t(pkg, x[:, i:i + 1])
            out, cache = layer(xi, xi, xi, None, cache)
            steps.append(_np(out))
        assert isinstance(cache, type(layer).Cache)
        assert tuple(cache.k.shape) == (2, 6, 4, 4)
        np.testing.assert_allclose(np.concatenate(steps, 1), _np(whole),
                                   rtol=RTOL, atol=ATOL)


def test_static_cache_matches_reference():
    ref, port = _pair(lambda: rnn.MultiHeadAttention(16, 4),
                      lambda: tnn.MultiHeadAttention(16, 4, device="cpu"))
    r = np.random.RandomState(3)
    q, mem = r.randn(2, 3, 16).astype(np.float32), r.randn(
        2, 5, 16).astype(np.float32)
    outs = []
    for pkg, layer in ((paddle, ref), (pt, port)):
        sc = layer.gen_cache(_t(pkg, mem), type=type(layer).StaticCache)
        assert isinstance(sc, type(layer).StaticCache)
        outs.append(_np(layer(_t(pkg, q), cache=sc)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    assert tnn.MultiHeadAttention.Cache is tnn.layer.transformer.Cache


def test_decode_cache_stays_float32_under_bf16_auto_cast():
    ref, port = _pair(lambda: rnn.MultiHeadAttention(16, 4),
                      lambda: tnn.MultiHeadAttention(16, 4, device="cpu"))
    x = np.random.RandomState(4).randn(2, 1, 16).astype(np.float32)
    res = []
    for pkg, layer, ctx in ((paddle, ref, paddle.amp.auto_cast),
                            (pt, port, amp.auto_cast)):
        xt = _t(pkg, x).astype("bfloat16") if pkg is paddle else _t(
            pkg, x).to(torch.bfloat16)
        cache = layer.gen_cache(xt)
        with ctx(dtype="bfloat16"):
            out, cache = layer(xt, xt, xt, None, cache)
            out, cache = layer(xt, xt, xt, None, cache)
        res.append((str(cache.k.dtype), str(out.dtype), _np(out)))
    assert res[0][0].endswith("float32") and res[1][0].endswith("float32")
    assert res[1][1].split(".")[-1] == res[0][1].split(".")[-1]
    assert np.abs(res[1][2] - res[0][2]).max() <= BF16_REL * np.abs(
        res[0][2]).max()


LAYER_CASES = {  # name: (maker(nn, dev), inputs: (shape) or "mask")
    "encoder_layer_post": (lambda nn, d: nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, **d), [(2, 5, 16), "pad_mask"]),
    "encoder_layer_pre_gelu": (lambda nn, d: nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0, activation="gelu", normalize_before=True,
        **d), [(2, 5, 16)]),
    "encoder_stack_norm": (lambda nn, d: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                   normalize_before=True, **d), 2,
        nn.LayerNorm(16, **d)), [(2, 5, 16), "pad_mask"]),
    "decoder_layer_post": (lambda nn, d: nn.TransformerDecoderLayer(
        16, 4, 32, dropout=0.0, **d), [(2, 4, 16), (2, 5, 16), "causal",
                                       "pad_mask"]),
    "decoder_stack_pre": (lambda nn, d: nn.TransformerDecoder(
        nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                                   normalize_before=True, **d), 2),
        [(2, 4, 16), (2, 5, 16), "causal"]),
    "transformer": (lambda nn, d: nn.Transformer(
        16, 4, 2, 2, 32, dropout=0.0, **d),
        [(2, 5, 16), (2, 4, 16), "pad_mask", "causal", "pad_mask"]),
    "transformer_pre_norm": (lambda nn, d: nn.Transformer(
        16, 4, 1, 2, 32, dropout=0.0, normalize_before=True, **d),
        [(2, 5, 16), (2, 4, 16), None, "causal"]),
}


def _layer_inputs(pkg, nn, case):
    r = np.random.RandomState(sum(map(ord, case)))
    out, diff = [], []
    for spec in LAYER_CASES[case][1]:
        if spec is None:
            out.append(None)
        elif spec == "causal":
            out.append(nn.Transformer.generate_square_subsequent_mask(4)
                       if pkg is paddle else
                       nn.Transformer.generate_square_subsequent_mask(
                           4, device="cpu"))
        elif spec == "pad_mask":
            keep = np.ones((2, 1, 1, 5), bool)
            keep[1, ..., 3:] = False
            out.append(_t(pkg, np.where(keep, 0.0, -1e9).astype(
                np.float32)))
        else:
            a = r.randn(*spec).astype(np.float32)
            out.append(_t(pkg, a, True))
            diff.append(out[-1])
    return out, diff


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_transformer_layers_match_reference(case):
    build = LAYER_CASES[case][0]
    ref, port = _pair(lambda: build(rnn, {}),
                      lambda: build(tnn, {"device": "cpu"}))
    assert list(port.state_dict()) == list(ref.state_dict())
    rin, rdiff = _layer_inputs(paddle, rnn, case)
    pin, pdiff = _layer_inputs(pt, tnn, case)
    want, got = ref(*rin), port(*pin)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    _check_grads(ref, port, want, got, rdiff, pdiff)


def test_transformer_defaults_are_transformer_base():
    m = tnn.Transformer(device="cpu")
    n = sum(p.numel() for p in m.parameters())
    ref = sum(int(np.prod(p.shape)) for p in rnn.Transformer().parameters())
    assert n == ref == 44_138_496
    assert len(m.encoder.layers) == len(m.decoder.layers) == 6
    layer = m.encoder.layers[0]
    assert layer.self_attn.num_heads == 8 and layer.linear1.weight.shape[
        1] == 2048 and layer.dropout1.p == 0.1
    assert not layer.normalize_before and m.encoder.norm is None


def test_square_subsequent_mask_is_the_reference():
    got = tnn.Transformer.generate_square_subsequent_mask(5, device="cpu")
    want = rnn.Transformer.generate_square_subsequent_mask(5)
    assert type(got) is pt.Tensor and got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.Transformer.generate_square_subsequent_mask(5)


# -- the flash gate through MultiHeadAttention ----------------------------------

@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    real = fa.flash_attention_bshd

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_bshd", spy)
    return calls


@pytest.mark.parametrize("arm", ["no_mask", "mask", "dropout"])
def test_the_flash_gate_through_multi_head_attention(arm, flash_calls):
    dropout = 0.1 if arm == "dropout" else 0.0
    ref, port = _pair(lambda: rnn.MultiHeadAttention(64, 2, dropout=dropout),
                      lambda: tnn.MultiHeadAttention(64, 2, dropout=dropout,
                                                     device="cpu"))
    x = np.random.RandomState(5).randn(1, 1024, 64).astype(np.float32)
    mask = (np.zeros((1, 1, 1, 1024), np.float32) if arm == "mask"
            else None)
    got = port(torch.from_numpy(x), attn_mask=None if mask is None
               else torch.from_numpy(mask))
    if arm == "no_mask":
        assert flash_calls == [(1, 1024, 2, 32)]
        want = ref(paddle.to_tensor(x))  # the reference writes it out here
        rel = np.linalg.norm(_np(got) - _np(want)) / np.linalg.norm(
            _np(want))
        assert rel < FLASH_RTOL
    else:
        assert flash_calls == []


# -- the tiny Transformer MT model ------------------------------------------------

V, D, HEADS, FFN, PAD, BOS, EOS = 50, 32, 4, 64, 0, 1, 2
B, S_LEN, T_LEN, STEPS, EPS = 4, 7, 6, 3, 0.1


def _sinusoid(n, d):
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return out


POS = _sinusoid(64, D)


def _batch(seed):
    r = np.random.RandomState(seed)
    src = r.randint(3, V, (B, S_LEN))
    tgt = r.randint(3, V, (B, T_LEN + 1))
    tgt[:, 0] = BOS
    for row, (ls, lt) in enumerate(zip(r.randint(3, S_LEN + 1, B),
                                       r.randint(3, T_LEN + 2, B))):
        src[row, ls:] = PAD
        tgt[row, lt:] = PAD
    return src, tgt


class _RefMT:
    def __init__(self):
        self.emb = rnn.Embedding(V, D)
        self.model = rnn.Transformer(D, HEADS, 2, 2, FFN, dropout=0.0)
        self.layers = (self.emb, self.model)

    def parameters(self):
        return self.emb.parameters() + self.model.parameters()

    def embed(self, ids, start=0):
        x = self.emb(ids) * math.sqrt(D)
        return x + paddle.to_tensor(POS[start:start + ids.shape[-1]])

    def logits(self, h):
        return paddle.matmul(h, self.emb.weight, transpose_y=True)

    def pad_mask(self, src):
        return paddle.to_tensor(np.where(
            np.asarray(src.numpy()) == PAD, -1e9, 0.0).astype(
                np.float32)[:, None, None, :])


class _PortMT:
    def __init__(self):
        self.emb = tnn.Embedding(V, D, device="cpu")
        self.model = tnn.Transformer(D, HEADS, 2, 2, FFN, dropout=0.0,
                                     device="cpu")
        self.layers = (self.emb, self.model)

    def parameters(self):
        return self.emb.parameters() + self.model.parameters()

    def embed(self, ids, start=0):
        x = self.emb(ids) * math.sqrt(D)
        return x + torch.from_numpy(POS[start:start + ids.shape[-1]])

    def logits(self, h):
        return F.linear(h, self.emb.weight.T)

    def pad_mask(self, src):
        return torch.where(src == PAD, -1e9, 0.0)[:, None, None, :]


def _mt_loss(pkg, m, src, tgt):
    nn, F_ = (rnn, RF) if pkg is paddle else (tnn, F)
    inp, lab = tgt[:, :-1], tgt[:, 1:]
    causal = (nn.Transformer.generate_square_subsequent_mask(T_LEN)
              if pkg is paddle else pt.core.tensor.unwrap(
                  nn.Transformer.generate_square_subsequent_mask(
                      T_LEN, device="cpu")))
    mask = m.pad_mask(src)
    h = m.model(m.embed(src), m.embed(inp), mask, causal, mask)
    logits = m.logits(h)
    soft = F_.label_smooth(F_.one_hot(lab, V), epsilon=EPS)
    loss = F_.cross_entropy(logits, soft, soft_label=True, reduction="none")
    weight = (lab != PAD).astype("float32") if pkg is paddle else (
        lab != PAD).float()
    return (loss.reshape(weight.shape) * weight).sum() / weight.sum()


def _decode_cell(pkg, m):
    """The decoder as a beam-search cell over the states [memory mask,
    per-layer (Cache, StaticCache)]: the mask leads, so the reference's
    ``initialize`` reads the batch from it (it takes ``states[0]``, which
    must be a tensor)."""
    def cell(inputs, states):
        mask, caches = states
        step = caches[0][0].k.shape[1]
        pos = POS[step:step + 1]
        x = inputs * math.sqrt(D) + (paddle.to_tensor(pos) if pkg is paddle
                                     else torch.from_numpy(pos))
        x = x.reshape([x.shape[0], 1, D])
        out, new = m.model.decoder(x, None, None, mask, caches)
        return out.reshape([out.shape[0], D]), [mask, new]
    return cell


def _beam_decode(pkg, m, src, beam=4, steps=8):
    nn = rnn if pkg is paddle else tnn
    mask = m.pad_mask(src)
    memory = m.model.encoder(m.embed(src), mask)
    caches = [(layer.self_attn.gen_cache(memory),
               layer.cross_attn.gen_cache(memory,
                                          type=type(layer.cross_attn)
                                          .StaticCache))
              for layer in m.model.decoder.layers]
    dec = nn.BeamSearchDecoder(_decode_cell(pkg, m), BOS, EOS, beam,
                               embedding_fn=m.emb, output_fn=m.logits)
    (ids, scores), _, lens = nn.dynamic_decode(dec, [mask, caches],
                                               max_step_num=steps)
    return _np(ids), _np(scores), _np(lens)


def test_tiny_transformer_mt_trains_and_beam_decodes_like_the_reference():
    ref, port = _RefMT(), _PortMT()
    for rl, pl in zip(ref.layers, port.layers):
        load_reference_state(pl, _state(rl))
    rsched = paddle.optimizer.lr.NoamDecay(d_model=D, warmup_steps=4)
    psched = optimizer.lr.NoamDecay(d_model=D, warmup_steps=4)
    ropt = paddle.optimizer.Adam(learning_rate=rsched, beta1=0.9, beta2=0.98,
                                 epsilon=1e-9, parameters=ref.parameters())
    popt = optimizer.Adam(learning_rate=psched, beta1=0.9, beta2=0.98,
                          epsilon=1e-9, parameters=port.parameters())
    for s in range(STEPS):
        src, tgt = _batch(s)
        rl = _mt_loss(paddle, ref, paddle.to_tensor(src),
                      paddle.to_tensor(tgt))
        rl.backward()
        ropt.step()
        ropt.clear_grad()
        rsched.step()
        pl = _mt_loss(pt, port, torch.from_numpy(src), torch.from_numpy(tgt))
        pl.backward()
        popt.step()
        popt.clear_grad()
        psched.step()
        np.testing.assert_allclose(float(pl.detach()), float(rl.numpy()),
                                   rtol=MT_REL)
        assert popt.get_lr() == pytest.approx(ropt.get_lr(), rel=1e-7)
    rates = sum(optimizer.lr.NoamDecay(D, 4, last_epoch=s - 1).last_lr
                for s in range(STEPS))
    for rl, pl in zip(ref.layers, port.layers):
        want = _state(rl)
        for n, t in pl.state_dict().items():
            tol = 2 * rates if n.endswith("k_proj.bias") \
                else MT_PARAM_SHARE * rates
            np.testing.assert_allclose(t.numpy(), want[n], rtol=0, atol=tol,
                                       err_msg=n)

    src, _ = _batch(10)
    for layer in ref.layers + port.layers:
        layer.eval()
    want = _beam_decode(paddle, ref, paddle.to_tensor(src))
    got = _beam_decode(pt, port, torch.from_numpy(src))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)
    assert got[0].shape == (B, got[0].shape[1], 4)
