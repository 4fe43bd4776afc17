"""Each ported functional and layer of the served path against its
``paddle_tpu`` counterpart, with the same weights (moved by
``paddle_tpu_torch.bridge``) and the same numpy inputs, in float32 on the
CPU. Tolerance: 1e-5 (the same float32 math in another order)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as pnn
import paddle_tpu.nn.functional as PF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.bridge import load_reference_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _state(layer):
    return {n: np.asarray(t.numpy()) for n, t in layer.state_dict().items()}


def _randomize(layer, rng):
    """Non-trivial reference weights (LayerNorm starts at ones/zeros)."""
    layer.set_state_dict({n: rng.randn(*v.shape).astype("float32")
                          for n, v in _state(layer).items()})
    return layer


def _pair(ref_layer, port_layer, rng, x):
    _randomize(ref_layer, rng)
    load_reference_state(port_layer, _state(ref_layer))
    want = ref_layer(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = port_layer(torch.from_numpy(x)).numpy()
    return want, got


def _linear(rng):
    return _pair(pnn.Linear(8, 16), tnn.Linear(8, 16, device="cpu"), rng,
                 rng.randn(3, 5, 8).astype("float32"))


def _embedding(rng):
    return _pair(pnn.Embedding(50, 8), tnn.Embedding(50, 8, device="cpu"),
                 rng, rng.randint(0, 50, (3, 7)).astype("int32"))


def _layer_norm(rng):
    return _pair(pnn.LayerNorm(16), tnn.LayerNorm(16, device="cpu"), rng,
                 rng.randn(4, 6, 16).astype("float32") * 3 + 1)


def _gelu(rng):
    x = rng.randn(5, 33).astype("float32") * 3
    return (PF.gelu(paddle.to_tensor(x)).numpy(),
            TF.gelu(torch.from_numpy(x)).numpy())


def _shape_ops(rng):
    """GPTBlock's qkv split and the tied LM head:
    reshape -> unstack(axis=2) -> matmul(transpose_y=True)."""
    x = rng.randn(2, 6, 3 * 4 * 8).astype("float32")
    w = rng.randn(10, 8).astype("float32")

    def run(mod, t):
        q, k, _v = mod.unstack(mod.reshape(t(x), [2, 6, 3, 4, 8]), axis=2)
        return mod.matmul(q + k, t(w), transpose_y=True)

    return (run(paddle, paddle.to_tensor).numpy(),
            run(tops, torch.from_numpy).numpy())


def _sdpa(seq, causal, mask=False):
    def case(rng):
        q, k, v = (rng.randn(2, seq, 2, 16).astype("float32")
                   for _ in range(3))
        m = rng.rand(2, 2, seq, seq) > 0.3 if mask else None
        m = None if m is None else m | np.eye(seq, dtype=bool)
        want = PF.scaled_dot_product_attention(
            *(paddle.to_tensor(a) for a in (q, k, v)),
            attn_mask=None if m is None else paddle.to_tensor(m),
            is_causal=causal).numpy()
        got = TF.scaled_dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            attn_mask=None if m is None else torch.from_numpy(m),
            is_causal=causal).numpy()
        return want, got
    return case


CASES = {
    "linear": _linear,
    "embedding": _embedding,
    "layer_norm": _layer_norm,
    "gelu_exact": _gelu,
    "reshape_unstack_matmul": _shape_ops,
    # below the 1024 gate: the written-out attention on both sides
    "sdpa_s64": _sdpa(64, False),
    "sdpa_s64_causal": _sdpa(64, True),
    "sdpa_s64_bool_mask": _sdpa(64, False, mask=True),
    # at the gate: the port's flash branch (plain version on the CPU)
    "sdpa_s1024": _sdpa(1024, False),
    "sdpa_s1024_causal": _sdpa(1024, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_reference(name):
    want, got = CASES[name](np.random.RandomState(sorted(CASES).index(name)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
