"""The LoD sequence ops and the decoding tail (``ops.sequence``) against
the reference's, on the CPU: the same seeded inputs through both
packages, outputs equal (integer results, the host's restructuring) or
within ``RTOL``/``ATOL`` (float32), and the gradients of the
differentiable ops within ``GRAD_RTOL``/``GRAD_ATOL``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.ops import sequence as RS
from paddle_tpu_torch.ops import sequence as S

RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _t(pkg, a, grad=False):
    diff = grad and a.dtype == np.float32
    if pkg is paddle:
        return paddle.to_tensor(a, stop_gradient=not diff)
    return pt.to_tensor(a, place="cpu", stop_gradient=not diff)


LENGTHS = np.array([4, 1, 3], np.int32)


def _data(r, *tail):
    return r.randn(3, 4, *tail).astype(np.float32)


# name: maker(r) -> (function name, positional args, keyword args)
CASES = {
    "sequence_mask": lambda r: ("sequence_mask", [LENGTHS], {}),
    "sequence_mask_maxlen_float": lambda r: (
        "sequence_mask", [LENGTHS], {"maxlen": 6, "dtype": "float32"}),
    "sequence_reverse": lambda r: ("sequence_reverse", [_data(r, 2),
                                                        LENGTHS], {}),
    "sequence_reverse_2d": lambda r: ("sequence_reverse", [_data(r),
                                                           LENGTHS], {}),
    "sequence_reverse_whole": lambda r: ("sequence_reverse", [_data(r, 2)],
                                         {}),
    "sequence_softmax": lambda r: ("sequence_softmax", [_data(r), LENGTHS],
                                   {}),
    **{f"sequence_pool_{p}": (lambda r, p=p: (
        "sequence_pool", [_data(r, 2), LENGTHS], {"pool_type": p}))
       for p in ("sum", "average", "sqrt", "max", "first", "last")},
    "sequence_first_step": lambda r: ("sequence_first_step",
                                      [_data(r, 2), LENGTHS], {}),
    "sequence_last_step": lambda r: ("sequence_last_step",
                                     [_data(r, 2), LENGTHS], {}),
    "sequence_expand": lambda r: ("sequence_expand",
                                  [_data(r), np.array([2, 0, 1])], {}),
    "sequence_expand_as": lambda r: ("sequence_expand_as",
                                     [_data(r), np.array([1, 3, 2])], {}),
    "sequence_enumerate": lambda r: (
        "sequence_enumerate", [r.randint(1, 9, (3, 5))],
        {"win_size": 3, "pad_value": -1}),
    "gather_tree": lambda r: ("gather_tree", [
        r.randint(0, 9, (5, 2, 3)), r.randint(0, 3, (5, 2, 3))], {}),
    "row_conv": lambda r: ("row_conv", [_data(r, 3), r.randn(2, 3).astype(
        np.float32)], {}),
    "sequence_conv": lambda r: ("sequence_conv", [
        _data(r, 2), r.randn(6, 5).astype(np.float32), 3], {}),
    "sequence_conv_lengths_start": lambda r: ("sequence_conv", [
        _data(r, 2), r.randn(8, 3).astype(np.float32), 4],
        {"context_start": -2, "lengths": LENGTHS, "padding_value": 0.5}),
    "sequence_reshape": lambda r: ("sequence_reshape", [_data(r, 6), 4],
                                   {}),
    "sequence_scatter": lambda r: ("sequence_scatter", [
        r.randn(3, 6).astype(np.float32), np.array([[0, 2], [5, 5],
                                                    [1, 3]]),
        r.randn(3, 2).astype(np.float32)], {}),
    "im2sequence": lambda r: ("im2sequence", [r.randn(2, 3, 5, 6).astype(
        np.float32)], {"filter_size": [2, 3], "stride": [1, 2],
                       "padding": 1}),
}


def _run(pkg, case, grad):
    r = np.random.RandomState(sum(map(ord, case)))
    name, args, kw = CASES[case](r)
    diff = []

    def t(a):
        if not isinstance(a, np.ndarray):
            return a
        v = _t(pkg, a, grad)
        if grad and a.dtype == np.float32:
            diff.append(v)
        return v

    mod = RS if pkg is paddle else S
    out = getattr(mod, name)(*[t(a) for a in args],
                             **{k: t(v) for k, v in kw.items()})
    return out, diff


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_op_matches_reference(case):
    want, _ = _run(paddle, case, False)
    got, _ = _run(pt, case, False)
    assert type(got) is pt.Tensor
    w, g = _np(want), _np(got)
    assert g.shape == w.shape
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(g, w)


# the reference's sequence_expand is a host copy (no gradient); the
# port's repeats on the device, differentiably
GRAD_CASES = sorted(c for c in CASES if any(
    isinstance(a, np.ndarray) and a.dtype == np.float32
    for a in CASES[c](np.random.RandomState(0))[1])
    and not c.startswith("sequence_expand"))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_sequence_op_gradient_matches_reference(case):
    grads = []
    for pkg in (paddle, pt):
        out, ins = _run(pkg, case, True)
        c = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
        ct = paddle.to_tensor(c) if pkg is paddle else pt.to_tensor(
            c, place="cpu")
        grads.append(pkg.grad([(out * ct).sum()], ins))
    for w, g in zip(*grads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


ROWS = [np.array([3, 1, 4, 1]), np.array([5]), np.array([9, 2, 6])]


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_ragged_batch_round_trip():
    rb = S.RaggedBatch.from_list(ROWS, pad_value=-1, device="cpu")
    ref = RS.RaggedBatch.from_list(ROWS, pad_value=-1)
    np.testing.assert_array_equal(_np(rb.data), _np(ref.data))
    np.testing.assert_array_equal(_np(rb.lengths), _np(ref.lengths))
    assert rb.lengths.dtype == torch.int32 and list(rb.shape) == [3, 4]
    _rows_equal(rb.to_list(), ROWS)
    data, lengths = S.sequence_pad(rb)
    _rows_equal(S.sequence_unpad(data, lengths), ROWS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.RaggedBatch.from_list(ROWS)


@pytest.mark.parametrize("op", ["concat", "slice", "erase"])
def test_host_restructuring_matches_reference(op):
    rb = S.RaggedBatch.from_list(ROWS, device="cpu")
    ref = RS.RaggedBatch.from_list(ROWS)
    if op == "concat":
        got = S.sequence_concat([rb, S.RaggedBatch.from_list(
            ROWS[::-1], device="cpu")])
        want = RS.sequence_concat([ref, RS.RaggedBatch.from_list(ROWS[::-1])])
    elif op == "slice":
        got = S.sequence_slice(rb, np.array([1, 0, 1]), np.array([2, 1, 2]))
        want = RS.sequence_slice(ref, np.array([1, 0, 1]),
                                 np.array([2, 1, 2]))
    else:
        got = S.sequence_erase(rb, [1, 9])
        want = RS.sequence_erase(ref, [1, 9])
    _rows_equal(got.to_list(), want.to_list())
    assert got.data.device.type == "cpu"


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_matches_reference(normalized):
    r = np.random.RandomState(3)
    a, b = r.randint(0, 4, (4, 6)), r.randint(0, 4, (4, 5))
    la, lb = np.array([6, 3, 0, 5]), np.array([5, 5, 2, 0])
    got, n = S.edit_distance(torch.from_numpy(a), torch.from_numpy(b),
                             normalized, torch.from_numpy(la),
                             torch.from_numpy(lb))
    want, wn = RS.edit_distance(paddle.to_tensor(a), paddle.to_tensor(b),
                                normalized, paddle.to_tensor(la),
                                paddle.to_tensor(lb))
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    assert got.dtype == torch.float32 and int(n) == int(wn.numpy()) == 4


def test_ctc_align_matches_reference():
    x = np.array([[0, 1, 1, 0, 2, 2, 3], [4, 4, 0, 4, 0, 0, 5],
                  [1, 2, 3, 3, 3, 0, 1]])
    ln = np.array([7, 6, 4])
    got = S.ctc_align(torch.from_numpy(x), torch.from_numpy(ln),
                      padding_value=-1)
    want = RS.ctc_align(paddle.to_tensor(x), paddle.to_tensor(ln),
                        padding_value=-1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_gather_tree_body_is_plain_for_the_decoder():
    ids = torch.tensor([[[2, 3]], [[4, 5]]])
    parents = torch.tensor([[[0, 0]], [[1, 0]]])
    out = S.gather_tree.__wrapped__(ids, parents)
    assert type(out) is torch.Tensor
    assert out.tolist() == [[[3, 2]], [[4, 5]]]
