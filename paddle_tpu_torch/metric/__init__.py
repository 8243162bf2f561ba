"""Metrics (reference: ``paddle_tpu/metric/__init__.py``, lines 1-167:
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and
``accuracy``).

All on the host in numpy, as in the reference: predictions and labels
are numpy arrays or tensors (a tensor on the card comes off it, which
waits for the card). ``Auc`` buckets the positive-class probability
into ``num_thresholds + 1`` bins (4095 thresholds by default) and sums
the ROC curve's trapezoids over them, the reference's algorithm.
``accuracy`` returns a 0-dim fp32 CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy (metrics.py:180)."""

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        correct = idx == label[..., None]
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        n = correct[..., 0].size
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(-1).sum()
            accs.append(float(c) / max(n, 1))
            self.correct[i] += int(c)
        self.total += n
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.correct = [0] * len(self.topk)
        self.total = 0

    def accumulate(self):
        res = [c / max(self.total, 1) for c in self.correct]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC by the reference's thresholded buckets."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bucket = np.clip(
            (pos_prob * self.num_thresholds).astype(np.int64), 0,
            self.num_thresholds
        )
        is_pos = labels.astype(bool)
        np.add.at(self._stat_pos, bucket[is_pos], 1)
        np.add.at(self._stat_neg, bucket[~is_pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        # trapezoid over buckets, vectorized as a prefix sum (identical
        # math to the reference's high-to-low scalar loop)
        pos = np.asarray(self._stat_pos, np.float64)[::-1]
        neg = np.asarray(self._stat_neg, np.float64)[::-1]
        cp, cn = np.cumsum(pos), np.cumsum(neg)
        auc = float(((cp + (cp - pos)) * (cn - (cn - neg)) / 2.0).sum())
        denom = float(cp[-1]) * float(cn[-1]) if cp.size else 0.0
        return float(auc / denom) if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy (paddle.metric.accuracy)."""
    pred = _np(input)
    lbl = _np(label)
    idx = np.argsort(-pred, axis=-1)[..., :k]
    if lbl.ndim == pred.ndim:
        lbl = lbl.squeeze(-1)
    acc = (idx == lbl[..., None]).any(-1).mean()
    return torch.as_tensor(np.asarray(acc, np.float32))
