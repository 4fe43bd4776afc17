"""The RNN layers, cells and beam search against the reference's, on the
CPU, with the reference's weights (``bridge.load_reference_state``).

- ``SimpleRNN`` (tanh, relu), ``LSTM`` and ``GRU`` over directions,
  depths, batch- and time-major inputs and given initial states: outputs,
  final states and the gradients of every input and weight within
  ``RTOL``/``ATOL`` and ``GRAD_RTOL``/``GRAD_ATOL`` (float32: the same
  cell math summed in another order). The dropout between layers at the
  same mask. A bf16 input against float32 weights computes in float32 on
  both sides.
- The three cells, with and without states, and ``get_initial_states``.
- ``BeamSearchDecoder`` + ``dynamic_decode``: the reference's own toy
  cells (the optimal path; lengths through reordered parents) and a
  ``GRUCell`` with an embedding and a projection: ids and lengths equal,
  scores within ``RTOL``. Ties in the top-k go to the lower index, as
  ``jax.lax.top_k`` puts them.
- A tiny LSTM language model (vocab 50, 2 x 16, dropout 0) takes 3 SGD
  steps at rate 1.0 under ``ClipGradByGlobalNorm``: losses within
  ``LM_REL`` relative, parameters within ``LM_PARAM_ATOL`` (float32, three
  steps of the same math).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.bridge import load_reference_state

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LM_REL, LM_PARAM_ATOL = 1e-5, 1e-5


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


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _flat(item)]
    return [x]


LAYERS = {  # name: (class name, keyword args)
    "simple_rnn_tanh": ("SimpleRNN", {}),
    "simple_rnn_relu": ("SimpleRNN", {"activation": "relu"}),
    "lstm": ("LSTM", {}),
    "lstm_2_layers": ("LSTM", {"num_layers": 2}),
    "lstm_bidirect": ("LSTM", {"direction": "bidirect"}),
    "lstm_bidirect_2_time_major": ("LSTM", {"num_layers": 2,
                                            "direction": "bidirectional",
                                            "time_major": True}),
    "gru": ("GRU", {}),
    "gru_2_layers_bidirect": ("GRU", {"num_layers": 2,
                                      "direction": "bidirect"}),
    "simple_rnn_bidirect_time_major": ("SimpleRNN", {"direction": "bidirect",
                                                     "time_major": True}),
}


def _run_layer(pkg, layer, x, states, kind):
    xt = (paddle.to_tensor(x, stop_gradient=False) if pkg is paddle
          else pt.to_tensor(x, place="cpu", stop_gradient=False))
    ins = [xt]
    init = None
    if states is not None:
        st = [paddle.to_tensor(s, stop_gradient=False) if pkg is paddle
              else pt.to_tensor(s, place="cpu", stop_gradient=False)
              for s in states]
        ins += st
        init = tuple(st) if kind == "LSTM" else st[0]
    out, final = layer(xt, init)
    outs = [out] + _flat(final)
    total = sum((o * (i + 1.0)).sum() for i, o in enumerate(outs))
    grads = pkg.grad([total], ins + layer.parameters())
    return [_np(o) for o in outs], [_np(g) for g in grads]


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("case", sorted(LAYERS))
def test_rnn_layer_matches_reference(case, with_states):
    kind, kw = LAYERS[case]
    r = np.random.RandomState(sum(map(ord, case)))
    nl = kw.get("num_layers", 1) * (2 if "direction" in kw else 1)
    b, t, i, h = 3, 5, 4, 6
    x = r.randn(*((t, b, i) if kw.get("time_major") else (b, t, i))
                ).astype(np.float32)
    states = None
    if with_states:
        states = [r.randn(nl, b, h).astype(np.float32)
                  for _ in range(2 if kind == "LSTM" else 1)]
    ref, port = _pair(lambda: getattr(rnn, kind)(i, h, **kw),
                      lambda: getattr(tnn, kind)(i, h, device="cpu", **kw))
    assert list(port.state_dict()) == list(ref.state_dict())
    want, wg = _run_layer(paddle, ref, x, states, kind)
    got, gg = _run_layer(pt, port, x, states, kind)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for n, (w, g) in enumerate(zip(wg, gg)):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{case} d{n}")


def test_weight_names_layouts_and_gate_order():
    lstm = tnn.LSTM(3, 5, num_layers=2, direction="bidirect", device="cpu")
    shapes = {n: tuple(p.shape) for n, p in lstm.named_parameters()}
    assert shapes["weight_ih_l0"] == (20, 3)
    assert shapes["weight_ih_l1_reverse"] == (20, 10)
    assert shapes["weight_hh_l1"] == (20, 5) and shapes["bias_hh_l0"] == (20,)
    assert tuple(tnn.GRU(3, 5, device="cpu").weight_ih_l0.shape) == (15, 3)
    # gate order i, f, c, o: the input gate (the first quarter) held shut
    # by a bias of -30 leaves the cell state at zero
    cell = tnn.LSTMCell(2, 3, device="cpu")
    with torch.no_grad():
        cell.bias_ih[:3] = -30.0  # i: the first quarter
    h, (h2, c) = cell(torch.ones(1, 2))
    assert torch.allclose(c, torch.zeros(1, 3), atol=1e-6)


def test_dropout_between_layers_matches_reference_at_the_same_mask(
        monkeypatch):
    import jax
    r = np.random.RandomState(3)
    x = r.randn(2, 4, 3).astype(np.float32)
    keep = r.rand(4, 2, 5) >= 0.4  # time-major inside, [T, B, H]
    ref, port = _pair(lambda: rnn.LSTM(3, 5, num_layers=2, dropout=0.4),
                      lambda: tnn.LSTM(3, 5, num_layers=2, dropout=0.4,
                                       device="cpu"))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, s: jax.numpy.asarray(keep))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(
        keep.astype(np.float32)))
    want, _ = ref(paddle.to_tensor(x))
    got, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    port.eval()
    ref.eval()
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))[0]),
                               _np(ref(paddle.to_tensor(x))[0]),
                               rtol=RTOL, atol=ATOL)


def test_sequence_length_is_taken_and_ignored_as_in_the_reference():
    ref, port = _pair(lambda: rnn.GRU(3, 4), lambda: tnn.GRU(3, 4,
                                                             device="cpu"))
    x = np.random.RandomState(4).randn(2, 5, 3).astype(np.float32)
    lengths = np.array([5, 2])
    a, _ = port(torch.from_numpy(x), sequence_length=torch.from_numpy(
        lengths))
    b, _ = port(torch.from_numpy(x))
    assert torch.equal(a, b)
    want, _ = ref(paddle.to_tensor(x), sequence_length=paddle.to_tensor(
        lengths))
    np.testing.assert_allclose(_np(a), _np(want), rtol=RTOL, atol=ATOL)


def test_bf16_input_with_float32_weights_computes_in_float32():
    ref, port = _pair(lambda: rnn.LSTM(3, 4), lambda: tnn.LSTM(
        3, 4, device="cpu"))
    x = np.random.RandomState(5).randn(2, 3, 3).astype(np.float32)
    want, _ = ref(paddle.to_tensor(x).astype("bfloat16"))
    got, (h, c) = port(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32 and h.dtype == torch.float32
    assert "float32" in str(want.dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


CELLS = {"simple_tanh": ("SimpleRNNCell", {}),
         "simple_relu": ("SimpleRNNCell", {"activation": "relu"}),
         "lstm": ("LSTMCell", {}), "gru": ("GRUCell", {})}


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("case", sorted(CELLS))
def test_cell_matches_reference(case, with_states):
    kind, kw = CELLS[case]
    r = np.random.RandomState(sum(map(ord, case)) + with_states)
    ref, port = _pair(lambda: getattr(rnn, kind)(4, 5, **kw),
                      lambda: getattr(tnn, kind)(4, 5, device="cpu", **kw))
    x = r.randn(3, 4).astype(np.float32)
    sts = [r.randn(3, 5).astype(np.float32)
           for _ in range(2 if kind == "LSTMCell" else 1)]
    res = []
    for pkg, layer in ((paddle, ref), (pt, port)):
        def t(a):
            return (paddle.to_tensor(a, stop_gradient=False) if pkg is paddle
                    else pt.to_tensor(a, place="cpu", stop_gradient=False))
        xt, st = t(x), [t(s) for s in sts]
        states = None
        if with_states:
            states = tuple(st) if kind == "LSTMCell" else st[0]
        out, new = layer(xt, states)
        outs = [out] + _flat(new)
        total = sum((o * (i + 1.0)).sum() for i, o in enumerate(outs))
        ins = [xt] + (st if with_states else []) + layer.parameters()
        res.append(([_np(o) for o in outs],
                    [_np(g) for g in pkg.grad([total], ins)]))
    for w, g in zip(res[0][0] + res[0][1], res[1][0] + res[1][1]):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_get_initial_states_follows_the_batch():
    cell = tnn.GRUCell(2, 7, device="cpu")
    s = cell.get_initial_states(torch.zeros(3, 2), init_value=0.5)
    assert tuple(s.shape) == (3, 7) and s.dtype == torch.float32
    assert torch.equal(s, torch.full((3, 7), 0.5))
    ref = rnn.GRUCell(2, 7).get_initial_states(paddle.to_tensor(
        np.zeros((3, 2), np.float32)), init_value=0.5)
    np.testing.assert_array_equal(_np(s), _np(ref))


# -- beam search ----------------------------------------------------------------

TIES = {  # name: scores, k
    "inside_the_top": (np.array([[0.5, 1.0, 1.0, 0.2, 1.0, 0.5, -1e9, -1e9],
                                 [-1e9, -1e9, 0.0, 0.0, 0.0, 0.0, 3.0, 3.0]],
                                np.float32), 4),
    "at_the_boundary": (np.array([[0.0] * 12 + [1.0, 2.0] + [0.0] * 6,
                                  [-np.inf] * 18 + [0.5, -np.inf]],
                                 np.float32), 3),
    "none": (np.random.RandomState(8).randn(3, 50).astype(np.float32), 4),
    "whole_row": (np.array([[1.0, 1.0, 1.0]], np.float32), 2),
}


@pytest.mark.parametrize("case", sorted(TIES))
def test_top_k_breaks_ties_by_the_lower_index_as_jax_does(case):
    import jax
    from paddle_tpu_torch.nn.layer.rnn import top_k_lower_index_first
    scores, k = TIES[case]
    want_v, want_i = jax.lax.top_k(scores, k)
    got_v, got_i = top_k_lower_index_first(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _decode(pkg, nn, cell, init, **kw):
    dec = nn.BeamSearchDecoder(cell, **kw)
    it = (paddle.to_tensor(init) if pkg is paddle
          else pt.to_tensor(init, place="cpu"))
    return nn.dynamic_decode(dec, it, max_step_num=kw.pop("steps", 6))


def test_beam_search_finds_the_optimal_path_of_the_reference_toy():
    trans = np.log(np.array([[0.1, 0.5, 0.35, 0.05],
                             [0.05, 0.05, 0.05, 0.85],
                             [0.3, 0.3, 0.3, 0.1],
                             [0.25, 0.25, 0.25, 0.25]], np.float32))

    def toy(pkg):
        class Toy:
            def __call__(self, inputs, states):
                tok = np.asarray(inputs.numpy()).astype(int)
                out = trans[tok]
                return (paddle.to_tensor(out) if pkg is paddle
                        else torch.from_numpy(out)), states
        return Toy()

    res = []
    for pkg, nn in ((paddle, rnn), (pt, tnn)):
        dec = nn.BeamSearchDecoder(toy(pkg), start_token=0, end_token=3,
                                   beam_size=3)
        init = np.zeros((2, 1), np.float32)
        it = paddle.to_tensor(init) if pkg is paddle else pt.to_tensor(
            init, place="cpu")
        (ids, scores), _, lens = nn.dynamic_decode(dec, it, max_step_num=6)
        res.append((_np(ids), _np(scores), _np(lens)))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][2], res[0][2])
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(res[1][0][0, :2, 0], [1, 3])


def test_beam_lengths_follow_reordered_parents_as_in_the_reference():
    step_logits = [np.log(np.array(v, np.float32)) for v in (
        [[.6, .39, .01]] * 2, [[.1, .1, .8], [.45, .45, .1]],
        [[.1, .1, .8]] * 2, [[.05, .05, .9]] * 2)]

    def seq(pkg):
        class Seq:
            t = 0

            def __call__(self, inputs, states):
                tok = np.asarray(inputs.numpy()).astype(int) % 2
                out = step_logits[min(self.t, 3)][tok]
                self.t += 1
                return (paddle.to_tensor(out) if pkg is paddle
                        else torch.from_numpy(out)), states
        return Seq()

    res = []
    for pkg, nn in ((paddle, rnn), (pt, tnn)):
        dec = nn.BeamSearchDecoder(seq(pkg), start_token=0, end_token=2,
                                   beam_size=2)
        init = np.zeros((1, 1), np.float32)
        it = paddle.to_tensor(init) if pkg is paddle else pt.to_tensor(
            init, place="cpu")
        (ids, _), _, lens = nn.dynamic_decode(dec, it, max_step_num=4,
                                              output_time_major=True)
        res.append((_np(ids), _np(lens)))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][1], res[0][1])


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_search_over_a_gru_cell_matches_reference(beam):
    pairs = [_pair(lambda: rnn.GRUCell(8, 16),
                   lambda: tnn.GRUCell(8, 16, device="cpu")),
             _pair(lambda: rnn.Embedding(12, 8),
                   lambda: tnn.Embedding(12, 8, device="cpu")),
             _pair(lambda: rnn.Linear(16, 12),
                   lambda: tnn.Linear(16, 12, device="cpu"))]
    init = np.random.RandomState(6).randn(3, 16).astype(np.float32)
    res = []
    for side, (pkg, nn) in enumerate(((paddle, rnn), (pt, tnn))):
        cell, emb, proj = (p[side] for p in pairs)
        dec = nn.BeamSearchDecoder(cell, start_token=1, end_token=2,
                                   beam_size=beam, embedding_fn=emb,
                                   output_fn=proj)
        it = paddle.to_tensor(init) if pkg is paddle else pt.to_tensor(
            init, place="cpu")
        (ids, scores), states, lens = nn.dynamic_decode(dec, it,
                                                        max_step_num=7)
        res.append((_np(ids), _np(scores), _np(lens), _np(states)))
    np.testing.assert_array_equal(res[1][0], res[0][0])
    np.testing.assert_array_equal(res[1][2], res[0][2])
    for w, g in zip(res[0][1::2], res[1][1::2]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert res[1][0].shape[0] == 3 and res[1][0].shape[2] == beam


def test_dynamic_decode_returns_plain_tensors_for_plain_states():
    cell = tnn.GRUCell(4, 4, device="cpu")
    dec = tnn.BeamSearchDecoder(cell, 0, 1, 2, output_fn=lambda h: h)
    dec.embedding_fn = lambda t: torch.nn.functional.one_hot(t, 4).float()
    (ids, scores), states, lens = tnn.dynamic_decode(dec, torch.zeros(2, 4),
                                                     max_step_num=3)
    assert type(ids) is torch.Tensor and ids.dtype == torch.int32
    assert type(lens) is torch.Tensor and tuple(scores.shape) == (2, 2)


# -- the tiny LSTM language model ------------------------------------------------------

V, H, B, T, STEPS, CLIP = 50, 16, 4, 7, 3, 0.5


class _LM:
    """Embedding -> LSTM(2 layers) -> Linear over the vocabulary."""

    def __init__(self, nn, **dev):
        self.emb = nn.Embedding(V, H, **dev)
        self.lstm = nn.LSTM(H, H, num_layers=2, dropout=0.0, **dev)
        self.out = nn.Linear(H, V, **dev)
        self.layers = (self.emb, self.lstm, self.out)

    def parameters(self):
        return [p for layer in self.layers for p in layer.parameters()]

    def loss(self, F_, ids, labels):
        y, _ = self.lstm(self.emb(ids))
        logits = self.out(y)
        return F_.cross_entropy(logits.reshape([-1, V]),
                                labels.reshape([-1]))


def test_tiny_lstm_language_model_trains_like_the_reference():
    r = np.random.RandomState(7)
    data = r.randint(0, V, (STEPS, B, T + 1))
    ref = _LM(rnn)
    port = _LM(tnn, device="cpu")
    for rl, pl in zip(ref.layers, port.layers):
        load_reference_state(pl, _state(rl))
    ropt = paddle.optimizer.SGD(learning_rate=1.0,
                                parameters=ref.parameters(),
                                grad_clip=rnn.ClipGradByGlobalNorm(CLIP))
    popt = optimizer.SGD(learning_rate=1.0, parameters=port.parameters(),
                         grad_clip=tnn.ClipGradByGlobalNorm(CLIP))
    for s in range(STEPS):
        ids, lab = data[s, :, :-1], data[s, :, 1:]
        rl = ref.loss(RF, paddle.to_tensor(ids), paddle.to_tensor(lab))
        rl.backward()
        ropt.step()
        ropt.clear_grad()
        pl = port.loss(F, torch.from_numpy(ids), torch.from_numpy(lab))
        pl.backward()
        popt.step()
        popt.clear_grad()
        np.testing.assert_allclose(float(pl.detach()), float(rl.numpy()),
                                   rtol=LM_REL)
    for rl, pl in zip(ref.layers, port.layers):
        want = _state(rl)
        for n, t in pl.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[n], rtol=0,
                                       atol=LM_PARAM_ATOL, err_msg=n)
