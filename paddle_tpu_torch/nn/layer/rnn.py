"""The RNN layers, cells and beam search (counterpart:
``paddle_tpu/nn/layer/rnn.py``).

Weight names, layouts and gate orders are the reference's:
``weight_ih_l{k}[_reverse]`` ``[gates * hidden, input]``,
``weight_hh_l{k}[_reverse]`` ``[gates * hidden, hidden]`` and the two
biases; LSTM gates i, f, c, o; GRU r, z, c, with the reset gate on the
hidden projection and its bias. The reference runs the recurrence as one
``lax.scan``; here it is a loop over time of torch's cell ops
(``torch._VF.lstm_cell``, ``gru_cell``, ``rnn_tanh_cell``,
``rnn_relu_cell``: on the card two GEMMs and one fused elementwise kernel
a step, forward and backward), the same code on the CPU and the card, so
a k-step program captures it like any other op. Between layers the
package's ``F.dropout`` draws, as the reference's does. Mixed input and
weight dtypes compute in their promoted dtype (as ``jnp`` promotes);
under ``auto_cast`` the inputs pass ``cast_inputs`` under the reference's
op names (``LSTM``, ``GRU``, ``RNN_TANH``, ``RNN_RELU``, ``lstm_cell``,
``gru_cell``, ``rnn_cell``), which no list names: level O1 leaves them
as they come.

``sequence_length`` is taken and ignored, as the reference's
``_RNNBase.forward`` ignores it (the generic ``RNN`` wrapper of
``extras`` honours it).

``BeamSearchDecoder`` keeps its states flattened to ``[batch * beam,
...]`` and maps over nested states (tuples, lists, namedtuples such as
``MultiHeadAttention.Cache``) with ``torch.utils._pytree``, which keeps
the namedtuples' types, and reads the batch from the first leaf (the
reference reads ``states[0]``, so its first state must be a tensor). Its
top-k over ``beam * vocab`` scores puts ties at the lower index, as
``jax.lax.top_k`` does (:func:`top_k_lower_index_first`).
``dynamic_decode`` reads ``all(finished)`` on the host once a step, so
decoding is an eager loop.
"""
import math

import torch
from torch.utils import _pytree as pytree

from ...amp.auto_cast import cast_inputs
from ...core.tensor import Tensor, unwrap, wrap
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNN", "LSTM", "GRU", "RNNCellBase", "SimpleRNNCell",
           "LSTMCell", "GRUCell", "BeamSearchDecoder", "dynamic_decode"]

# mode: (cell op, gates, has a cell state)
_CELLS = {"LSTM": (torch._VF.lstm_cell, 4, True),
          "GRU": (torch._VF.gru_cell, 3, False),
          "RNN_TANH": (torch._VF.rnn_tanh_cell, 1, False),
          "RNN_RELU": (torch._VF.rnn_relu_cell, 1, False)}


def _promote(*tensors):
    """The tensors (None kept) in their promoted floating dtype."""
    dtype = None
    for t in tensors:
        if t is not None:
            dtype = t.dtype if dtype is None else torch.promote_types(
                dtype, t.dtype)
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def _run_direction(mode, x, wi, wh, bi, bh, h0, c0, reverse):
    """One layer's one direction over time-major ``x`` ``[T, B, I]``:
    (outputs ``[T, B, H]``, last h, last c or None)."""
    cell, _, has_cell = _CELLS[mode]
    x, wi, wh, bi, bh, h0, c0 = _promote(
        *cast_inputs(mode, x, wi, wh, bi, bh, h0, c0))
    h, c = h0, c0
    outs = []
    for t in (range(x.shape[0] - 1, -1, -1) if reverse
              else range(x.shape[0])):
        if has_cell:
            h, c = cell(x[t], (h, c), wi, wh, bi, bh)
        else:
            h = cell(x[t], h, wi, wh, bi, bh)
        outs.append(h)
    if reverse:
        outs.reverse()
    return torch.stack(outs), h, c


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, device=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        _, gates, self.has_cell = _CELLS[mode]

        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self._all_weights = []
        for layer in range(num_layers):
            for direction in range(self.num_directions):
                in_size = (input_size if layer == 0
                           else hidden_size * self.num_directions)
                suffix = "_reverse" if direction == 1 else ""
                shapes = ([gates * hidden_size, in_size],
                          [gates * hidden_size, hidden_size],
                          [gates * hidden_size], [gates * hidden_size])
                attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                         bias_hh_attr)
                names = [f"weight_ih_l{layer}{suffix}",
                         f"weight_hh_l{layer}{suffix}",
                         f"bias_ih_l{layer}{suffix}",
                         f"bias_hh_l{layer}{suffix}"]
                for i, (name, shape, attr) in enumerate(zip(names, shapes,
                                                            attrs)):
                    self.add_parameter(name, self.create_parameter(
                        shape, attr=attr, is_bias=i >= 2, device=device,
                        default_initializer=init))
                self._all_weights.append(names)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        b = x.shape[1]
        d = self.num_directions
        if initial_states is None:
            shape = (self.num_layers * d, b, self.hidden_size)
            h0 = torch.zeros(shape, dtype=torch.float32, device=x.device)
            c0 = torch.zeros(shape, dtype=torch.float32, device=x.device)
        elif self.has_cell:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, None

        h_finals, c_finals = [], []
        out = x
        for layer in range(self.num_layers):
            outs = []
            for direction in range(d):
                idx = layer * d + direction
                wi, wh, bi, bh = (getattr(self, n)
                                  for n in self._all_weights[idx])
                ys, h, c = _run_direction(
                    self.mode, out, wi, wh, bi, bh, h0[idx],
                    c0[idx] if self.has_cell else None, direction == 1)
                outs.append(ys)
                h_finals.append(h)
                c_finals.append(c)
            out = outs[0] if d == 1 else torch.cat(outs, dim=-1)
            if self.dropout > 0.0 and layer < self.num_layers - 1:
                out = F.dropout(out, self.dropout, training=self.training)

        h_n = torch.stack(h_finals)
        if not self.time_major:
            out = out.transpose(0, 1)
        if self.has_cell:
            return out, (h_n, torch.stack(c_finals))
        return out, h_n


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", device=None, **kwargs):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, **kwargs):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, **kwargs):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, device=device,
                         **kwargs)


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0):
        """``[batch, hidden]`` of ``init_value`` on ``batch_ref``'s
        device."""
        from ...core.dtype import convert_dtype
        return torch.full((batch_ref.shape[0], self.hidden_size), init_value,
                          dtype=convert_dtype(dtype),
                          device=batch_ref.device)


class _Cell(RNNCellBase):
    """A cell's four parameters (``weight_ih``, ``weight_hh``,
    ``bias_ih``, ``bias_hh``), uniform in +-1/sqrt(hidden); the weight
    attributes are taken and ignored, as in the reference."""

    def __init__(self, gates, input_size, hidden_size, device):
        super().__init__()
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        for name, shape, bias in (
                ("weight_ih", [gates * hidden_size, input_size], False),
                ("weight_hh", [gates * hidden_size, hidden_size], False),
                ("bias_ih", [gates * hidden_size], True),
                ("bias_hh", [gates * hidden_size], True)):
            setattr(self, name, self.create_parameter(
                shape, is_bias=bias, device=device,
                default_initializer=init))

    def _params(self, name, *states):
        return _promote(*cast_inputs(name, *states, self.weight_ih,
                                     self.weight_hh, self.bias_ih,
                                     self.bias_hh))


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 device=None, **kwargs):
        super().__init__(1, input_size, hidden_size, device)
        self._cell = (torch._VF.rnn_tanh_cell if activation == "tanh"
                      else torch._VF.rnn_relu_cell)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, wi, wh, bi, bh = self._params("rnn_cell", inputs, states)
        h = self._cell(x, h, wi, wh, bi, bh)
        return h, h


class LSTMCell(_Cell):
    def __init__(self, input_size, hidden_size, device=None, **kwargs):
        super().__init__(4, input_size, hidden_size, device)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self.get_initial_states(inputs)
        else:
            h, c = states
        x, h, c, wi, wh, bi, bh = self._params("lstm_cell", inputs, h, c)
        h, c = torch._VF.lstm_cell(x, (h, c), wi, wh, bi, bh)
        return h, (h, c)


class GRUCell(_Cell):
    def __init__(self, input_size, hidden_size, device=None, **kwargs):
        super().__init__(3, input_size, hidden_size, device)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        x, h, wi, wh, bi, bh = self._params("gru_cell", inputs, states)
        h = torch._VF.gru_cell(x, h, wi, wh, bi, bh)
        return h, h


def _plain(tree):
    """A nest of states with every ``Tensor`` as a plain tensor."""
    return pytree.tree_map(
        lambda s: unwrap(s) if type(s) is Tensor else s, tree)


def top_k_lower_index_first(scores, k):
    """The ``k`` largest of each row and their indices, ties to the lower
    index (``jax.lax.top_k``'s order): a stable descending sort keeps equal
    values in index order."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BeamSearchDecoder:
    """Beam search over a cell ``cell(inputs, states) -> (out,
    next_states)``: ``embedding_fn`` maps the last tokens to the cell's
    inputs, ``output_fn`` its outputs to logits. A finished beam may only
    emit ``end_token``, at no cost."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        """Each state repeated ``beam_size`` times along the batch (a
        row's beams adjacent); the first beam alive (log-probability 0),
        the others at -1e9; every token ``start_token``."""
        states = pytree.tree_map(
            lambda s: torch.repeat_interleave(s, self.beam_size, dim=0),
            _plain(initial_cell_states))
        first = pytree.tree_leaves(states)[0]
        bb = first.shape[0]
        b = bb // self.beam_size
        log_probs = torch.full((b, self.beam_size), -1e9,
                               dtype=torch.float32, device=first.device)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((b, self.beam_size), dtype=torch.bool,
                               device=first.device)
        tokens = torch.full((bb,), self.start_token, dtype=torch.long,
                            device=first.device)
        return tokens, states, log_probs, finished

    def step(self, tokens, cell_states, log_probs, finished):
        """One beam expansion: (next tokens, states, log-probabilities and
        finished flags, then this step's token ids and parent beams, both
        ``[batch, beam]``)."""
        beam = self.beam_size
        inputs = self.embedding_fn(tokens) if self.embedding_fn else tokens
        out, next_states = self.cell(inputs, cell_states)
        logits = unwrap(self.output_fn(out) if self.output_fn else out)
        v = logits.shape[-1]
        step_lp = torch.log_softmax(logits.float(), dim=-1).reshape(
            -1, beam, v)
        b = step_lp.shape[0]
        end_only = torch.full((v,), float("-inf"), device=step_lp.device)
        end_only[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], end_only, step_lp)
        scores = (log_probs[..., None] + step_lp).reshape(b, beam * v)
        top_lp, top_idx = top_k_lower_index_first(scores, beam)
        parents = top_idx // v
        next_ids = top_idx % v
        flat_parent = (parents + torch.arange(
            b, device=parents.device)[:, None] * beam).reshape(-1)
        next_states = pytree.tree_map(
            lambda s: s.index_select(0, flat_parent), _plain(next_states))
        next_finished = (finished.gather(1, parents)
                         | (next_ids == self.end_token))
        return (next_ids.reshape(-1), next_states, top_lp, next_finished,
                next_ids, parents)


def _dynamic_decode(decoder, inits=None, max_step_num=64,
                    output_time_major=False, **kwargs):
    """Run ``decoder`` until every beam has finished or for
    ``max_step_num`` steps: ((ids ``[batch, time, beam]``, or time-major,
    backtraced with ``gather_tree``; final log-probabilities), final
    states, lengths). A beam's length follows its parents and counts the
    step that emitted ``end_token``."""
    from ...ops.sequence import gather_tree
    tokens, states, log_probs, finished = decoder.initialize(inits)
    step_ids, step_parents = [], []
    lengths = torch.zeros(finished.shape, dtype=torch.int32,
                          device=finished.device)
    for _ in range(max_step_num):
        prev_finished = finished
        (tokens, states, log_probs, finished, ids,
         parents) = decoder.step(tokens, states, log_probs, finished)
        step_ids.append(ids)
        step_parents.append(parents)
        lengths = (lengths.gather(1, parents)
                   + (~prev_finished.gather(1, parents)).int())
        if bool(finished.all()):
            break
    traced = gather_tree.__wrapped__(torch.stack(step_ids),
                                     torch.stack(step_parents)).int()
    if not output_time_major:
        traced = traced.transpose(0, 1)
    return (traced, log_probs), states, lengths


def dynamic_decode(decoder, inits=None, max_step_num=64,
                   output_time_major=False, **kwargs):
    out = _dynamic_decode(decoder, _plain(inits), max_step_num,
                          output_time_major, **kwargs)
    return pytree.tree_map(wrap, out) if pytree.tree_any(
        lambda s: type(s) is Tensor, inits) else out


dynamic_decode.__doc__ = _dynamic_decode.__doc__
