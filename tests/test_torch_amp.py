"""The port's ``amp.auto_cast`` against the reference's: the output dtype
of each op on the port's AMP seam (``linear``, ``matmul``, ``embedding``,
``layer_norm``, ``scaled_dot_product_attention``, ``cross_entropy``) for
float32 and bf16 inputs, AMP off and on, with custom lists and at level
O2, and the values within bf16 tolerance (relative L2 <= 1e-2: both sides
round the same operands to bf16 and sum in float32 in another order).
"""
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import amp, ops

REL_L2 = 1e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _rng_arrays(seed):
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(2, 8, 16).astype("float32"),
        "w": (rng.randn(16, 12) * 0.3).astype("float32"),
        "b": rng.randn(12).astype("float32"),
        "y": rng.randn(2, 16, 5).astype("float32"),
        "table": rng.randn(30, 16).astype("float32"),
        "ids": rng.randint(0, 30, (2, 8)).astype("int32"),
        "gamma": (1 + 0.1 * rng.randn(16)).astype("float32"),
        "beta": (0.1 * rng.randn(16)).astype("float32"),
        "q": rng.randn(1, 32, 2, 16).astype("float32"),
        "logits": rng.randn(20, 30).astype("float32"),
        "labels": rng.randint(0, 30, (20,)).astype("int64"),
    }


def _ops(a, F_, matmul, t):
    """(name, thunk) per op, for one package (``t`` makes its tensors)."""
    q = t(a["q"])
    return [
        ("linear", lambda: F_.linear(t(a["x"]), t(a["w"]), t(a["b"]))),
        ("matmul", lambda: matmul(t(a["x"]), t(a["y"]))),
        ("embedding", lambda: F_.embedding(t(a["ids"]), t(a["table"]))),
        ("layer_norm", lambda: F_.layer_norm(t(a["x"]), 16, t(a["gamma"]),
                                             t(a["beta"]))),
        ("scaled_dot_product_attention",
         lambda: F_.scaled_dot_product_attention(q, q, q, is_causal=True)),
        ("cross_entropy", lambda: F_.cross_entropy(t(a["logits"]),
                                                   t(a["labels"]))),
    ]


def _ref_tensor(dtype):
    def t(x):
        v = paddle.to_tensor(x)
        return v.astype(dtype) if x.dtype == np.float32 else v
    return t


def _port_tensor(dtype):
    def t(x):
        v = torch.from_numpy(x)
        return v.to(dtype) if x.dtype == np.float32 else v
    return t


_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _run_both(in_dtype, amp_kw):
    a = _rng_arrays(0)
    ref_ops = _ops(a, RF, paddle.matmul, _ref_tensor(in_dtype))
    port_ops = _ops(a, F, ops.matmul, _port_tensor(_DT[in_dtype]))
    out = []
    for (name, ref_fn), (_, port_fn) in zip(ref_ops, port_ops):
        if amp_kw is None:
            want, got = ref_fn(), port_fn()
        else:
            with paddle.amp.auto_cast(**amp_kw):
                want = ref_fn()
            with amp.auto_cast(**amp_kw):
                got = port_fn()
        out.append((name, want, got))
    return out


def _check(results):
    for name, want, got in results:
        ref_dtype = str(want.dtype).replace("paddle.", "")
        assert str(got.dtype) == f"torch.{ref_dtype}", (name, want.dtype,
                                                        got.dtype)
        w = np.asarray(want.astype("float32").numpy(), dtype=np.float64)
        g = got.float().detach().numpy().astype(np.float64)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel <= REL_L2, (name, rel)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("amp_kw", [
    None,
    dict(enable=True, dtype="bfloat16"),
    dict(enable=False, dtype="bfloat16"),
    dict(enable=True, dtype="bfloat16", custom_black_list={"linear"},
         custom_white_list={"layer_norm", "cross_entropy"}),
    dict(enable=True, dtype="bfloat16", level="O2"),
], ids=["no_amp", "o1", "disabled", "custom_lists", "o2"])
def test_output_dtypes_match_reference(in_dtype, amp_kw):
    _check(_run_both(in_dtype, amp_kw))


def test_lists_are_the_reference_lists():
    ref_ac = sys.modules["paddle_tpu.amp.auto_cast"]
    assert amp.white_list == ref_ac.white_list
    assert amp.black_list == ref_ac.black_list
    assert amp.downcast_out_list == ref_ac.downcast_out_list


def test_state_nests_restores_and_is_thread_local():
    seen = {}

    def other():
        seen["enabled"] = amp.get_amp_state().enabled

    with amp.auto_cast(custom_white_list={"gelu"}):
        with amp.auto_cast(enable=False):
            assert not amp.get_amp_state().enabled
        st = amp.get_amp_state()
        assert st.enabled and st.custom_white == {"gelu"}
        th = threading.Thread(target=other)
        th.start()
        th.join()
    assert seen == {"enabled": False}
    assert not amp.get_amp_state().enabled


def test_layer_norm_keeps_the_stream_in_bf16_and_grads_flow():
    """fp32 parameters under O1: the embedding seeds a bf16 stream, the
    norm computes in f32 and hands bf16 on, a linear stays bf16; the
    parameters' grads come back float32."""
    a = _rng_arrays(1)
    table = torch.from_numpy(a["table"]).requires_grad_()
    gamma = torch.from_numpy(a["gamma"]).requires_grad_()
    w = torch.from_numpy(a["w"]).requires_grad_()
    with amp.auto_cast():
        h = F.embedding(torch.from_numpy(a["ids"]), table)
        n = F.layer_norm(h, 16, gamma)
        y = F.linear(n, w)
    assert (h.dtype, n.dtype, y.dtype) == (torch.bfloat16,) * 3
    y.float().sum().backward()
    assert table.grad.dtype == gamma.grad.dtype == w.grad.dtype == \
        torch.float32
