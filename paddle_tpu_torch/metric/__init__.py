"""Metrics (counterpart: ``paddle_tpu/metric``).

``compute`` and ``update`` run on the host in numpy, as the reference's
do: a prediction on the card is read back once, and ``Accuracy`` ranks it
with the reference's ``np.argsort(-pred)``, so ties rank alike. ``compute``
returns a CPU ``Tensor``; ``update`` takes it, numpy or any tensor.
``Auc`` bins each prediction into ``num_thresholds + 1`` buckets and
integrates the true-positive rate over the false-positive rate
(``curve`` is taken and unused, as in the reference). The functional
``accuracy`` runs on the input's device and takes the top k with a stable
sort, the lowest index first among ties, as ``lax.top_k`` does.
"""
import numpy as np
import torch

from ..core.tensor import Tensor, host_array

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "auc",
           "accuracy", "Tensor"]

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _host(x):
    return host_array(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _cpu_tensor(arr):
    return torch.from_numpy(np.ascontiguousarray(arr)).as_subclass(Tensor)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label):
        """A float32 ``[..., maxk]`` mask: whether the i-th ranked class is
        the label."""
        pred_np, label_np = _host(pred), _host(label)
        idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        if label_np.ndim == idx.ndim:
            label_np = label_np.squeeze(-1)
        return _cpu_tensor((idx == label_np[..., None]).astype(np.float32))

    def update(self, correct):
        c = _host(correct)
        accs = []
        num = int(np.prod(c.shape[:-1]))
        for i, k in enumerate(self.topk):
            n_correct = float(c[..., :k].sum())
            self.total[i] += n_correct
            self.count[i] += num
            accs.append(n_correct / max(num, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


def _binary(preds, labels):
    p = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
    return p, _host(labels).astype(np.int32).reshape(-1)


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p, l = _binary(preds, labels)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return [self._name]


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p, l = _binary(preds, labels)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return [self._name]


def _bins(preds, labels, num_thresholds):
    p, l = _host(preds), _host(labels)
    if p.ndim == 2 and p.shape[1] == 2:
        p = p[:, 1]
    p, l = p.reshape(-1), l.reshape(-1).astype(bool)
    bins = np.minimum((p * num_thresholds).astype(np.int64), num_thresholds)
    return bins, l


def _auc_value(stat_pos, stat_neg):
    tot_pos, tot_neg = stat_pos.sum(), stat_neg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return 0.0
    pos = stat_pos[::-1].cumsum()
    neg = stat_neg[::-1].cumsum()
    return float(_trapezoid(pos / tot_pos, neg / tot_neg))


class Auc(Metric):
    """Streaming AUC over thresholded confusion bins."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        bins, l = _bins(preds, labels, self.num_thresholds)
        np.add.at(self._stat_pos, bins[l], 1)
        np.add.at(self._stat_neg, bins[~l], 1)

    def accumulate(self):
        return _auc_value(self._stat_pos, self._stat_neg)

    def name(self):
        return [self._name]


def auc(input, label, num_thresholds=4095, stat_pos=None, stat_neg=None,  # noqa: A002
        curve="ROC", slide_steps=0):
    """The functional AUC: returns ``(auc, stat_pos, stat_neg)`` as CPU
    tensors; feed the statistics back in to accumulate, as the reference's
    persistable statistics do."""
    bins, l = _bins(input, label, num_thresholds)
    sp = (np.zeros(num_thresholds + 1) if stat_pos is None
          else _host(stat_pos).astype(np.float64))
    sn = (np.zeros(num_thresholds + 1) if stat_neg is None
          else _host(stat_neg).astype(np.float64))
    np.add.at(sp, bins[l], 1)
    np.add.at(sn, bins[~l], 1)
    return (_cpu_tensor(np.float32(_auc_value(sp, sn))),
            _cpu_tensor(sp.astype(np.int64)), _cpu_tensor(sn.astype(np.int64)))


def accuracy(input, label, k=1):  # noqa: A002
    """The share of rows whose label is among the top ``k`` scores (a
    float32 scalar tensor on the input's device)."""
    x = torch.as_tensor(input)
    idx = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    lab = torch.as_tensor(label, device=idx.device).reshape(-1, 1).long()
    correct = (idx.long() == lab).any(dim=-1)
    return correct.float().mean()
