"""``metric`` of the port against the reference's, on the same numpy
inputs: ``Accuracy`` (top-k, ties ranked by the same ``np.argsort``),
``Precision``, ``Recall``, ``Auc`` (the ``curve`` argument is taken and
unused by both) and the functionals ``auc`` and ``accuracy``. Every value
equals the reference's exactly (the same host numpy in the same order;
``accuracy`` takes the top k by a stable sort where the reference takes
``lax.top_k``, both the lowest index first among ties), whether the port
gets numpy or torch tensors.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as R
from paddle_tpu_torch import metric as M


def _scores(seed=0, n=64, c=6, ties=True):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, c).astype(np.float32)
    if ties:
        p[::3, 1] = p[::3, 2]  # equal scores at the top
        p[::5] = 0.5
    return p, rng.randint(0, c, (n, 1)).astype(np.int64)


def _values(m, batches, torch_in):
    out = []
    for p, y in batches:
        if torch_in:
            p, y = torch.from_numpy(p), torch.from_numpy(y)
        out.append(m.update(m.compute(p, y)))
    return out, m.accumulate(), m.name()


@pytest.mark.parametrize("torch_in", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("topk", [(1,), (1, 3), (2, 5)])
def test_accuracy_matches_the_reference(topk, torch_in):
    batches = [_scores(s) for s in range(3)]
    got = _values(M.Accuracy(topk=topk), batches, torch_in)
    want = _values(R.Accuracy(topk=topk), batches, False)
    assert got == want


def test_accuracy_compute_is_the_reference_mask():
    p, y = _scores(4)
    got = M.Accuracy(topk=(1, 2)).compute(torch.from_numpy(p), y)
    want = R.Accuracy(topk=(1, 2)).compute(p, y)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    m = M.Accuracy()
    m.update(got[..., :1])
    m.reset()
    assert m.accumulate() == 0.0 and m.name() == ["acc"]


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_and_recall_match_the_reference(cls):
    rng = np.random.RandomState(3)
    got_m, want_m = getattr(M, cls)(), getattr(R, cls)()
    for _ in range(3):
        p = rng.rand(40, 1).astype(np.float32)
        y = rng.randint(0, 2, (40, 1))
        got_m.update(torch.from_numpy(p), y)
        want_m.update(p, y)
        assert got_m.accumulate() == want_m.accumulate()
    assert got_m.name() == want_m.name()
    got_m.reset()
    assert got_m.accumulate() == 0.0


@pytest.mark.parametrize("curve", ["ROC", "PR"])
@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_matches_the_reference(curve, two_columns):
    rng = np.random.RandomState(5)
    got_m = M.Auc(curve=curve, num_thresholds=255)
    want_m = R.Auc(curve=curve, num_thresholds=255)
    for _ in range(3):
        p = rng.rand(50).astype(np.float32)
        y = (rng.rand(50) < p).astype(np.int64)
        if two_columns:
            p = np.stack([1 - p, p], axis=1)
        got_m.update(torch.from_numpy(p), torch.from_numpy(y))
        want_m.update(p, y)
    assert got_m.accumulate() == want_m.accumulate()
    np.testing.assert_array_equal(got_m._stat_pos, want_m._stat_pos)
    np.testing.assert_array_equal(got_m._stat_neg, want_m._stat_neg)


def test_auc_functional_accumulates_as_the_reference():
    rng = np.random.RandomState(6)
    p1, p2 = rng.rand(30).astype(np.float32), rng.rand(30).astype(np.float32)
    y1, y2 = rng.randint(0, 2, 30), rng.randint(0, 2, 30)
    g = M.auc(torch.from_numpy(p1), y1, num_thresholds=63)
    w = R.auc(p1, y1, num_thresholds=63)
    g2 = M.auc(p2, y2, num_thresholds=63, stat_pos=g[1], stat_neg=g[2])
    w2 = R.auc(p2, y2, num_thresholds=63, stat_pos=w[1], stat_neg=w[2])
    for got, want in ((g, w), (g2, w2)):
        assert float(got[0]) == float(want[0].numpy())
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_auc_with_one_class_is_zero():
    assert M.Auc().accumulate() == R.Auc().accumulate() == 0.0
    m = M.Auc()
    m.update(np.array([0.2, 0.9]), np.array([1, 1]))
    assert m.accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 2, 3])
def test_accuracy_functional_matches_the_reference(k):
    p, y = _scores(8)
    got = M.accuracy(torch.from_numpy(p), torch.from_numpy(y), k=k)
    want = R.accuracy(paddle.to_tensor(p), paddle.to_tensor(y), k=k)
    assert got.dtype == torch.float32
    assert float(got) == float(want.numpy())


def test_metric_base_and_tensor_reexport():
    assert M.Metric().compute(1, 2) == (1, 2)
    with pytest.raises(NotImplementedError):
        M.Metric().accumulate()
    import paddle_tpu_torch
    assert M.Tensor is paddle_tpu_torch.Tensor
