"""Loss layers (reference: ``paddle_tpu/nn/layer/loss.py``): each holds
its options and calls its functional (``functional/loss.py``), as the
reference's do. ``AdaptiveLogSoftmaxWithLoss`` (``:189``) holds the
head (``head_weight`` ``[in, cutoffs[0] + clusters]``, ``head_bias``
with ``head_bias=True``) and each cluster's projection pair
(``tail_proj_i`` ``[in, in // div_value^(i+1)]``, ``tail_out_i``), and
composes the full log-probabilities from them: the head's for the
frequent classes, the head's cluster log-probability plus the tail's
within it for the rest. ``HSigmoidLoss`` is not ported (ROADMAP Queue A
4c-2)."""
from __future__ import annotations

import torch

from ... import tensor as T
from ...framework.autograd import call_op
from .. import functional as F
from .layers import Layer

__all__ = ["BCELoss", "BCEWithLogitsLoss", "CrossEntropyLoss", "MSELoss",
           "L1Loss", "NLLLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "SoftMarginLoss", "PoissonNLLLoss",
           "GaussianNLLLoss", "MultiMarginLoss", "CTCLoss",
           "AdaptiveLogSoftmaxWithLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax, self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self._reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._args = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self._args)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (full, epsilon, reduction)

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, *self._args)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._args = (p, margin, reduction)
        self._weight = weight

    def forward(self, input, label):
        p, m, red = self._args
        return F.multi_margin_loss(input, label, p, m, self._weight, red)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean", name=None):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction, norm_by_times)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax (Grave et al.): ``forward(input [N, F], label
    [N])`` -> (each row's target log-probability [N], their mean negated,
    the loss)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if (not cutoffs or cutoffs != sorted(set(cutoffs))
                or cutoffs[-1] >= n_classes):
            raise ValueError("cutoffs must be increasing and < n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.n_clusters = len(self.cutoffs) - 1
        self.head_size = self.cutoffs[0] + self.n_clusters
        self.head_weight = self.create_parameter(
            shape=[in_features, self.head_size], device=device)
        self.head_bias = self.create_parameter(
            shape=[self.head_size], is_bias=True,
            device=device) if head_bias else None
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            setattr(self, f"tail_proj_{i}", self.create_parameter(
                shape=[in_features, hsz], device=device))
            setattr(self, f"tail_out_{i}", self.create_parameter(
                shape=[hsz, osz], device=device))
            self.tail_weights.append((f"tail_proj_{i}", f"tail_out_{i}"))

    def _log_probs(self, input):
        p = self._parameters
        params = [p["head_weight"]]
        if p.get("head_bias") is not None:
            params.append(p["head_bias"])
        for w1, w2 in self.tail_weights:
            params += [p[w1], p[w2]]
        has_bias = p.get("head_bias") is not None
        cut = self.cutoffs

        def fn(x, *ws):
            ws = list(ws)
            head = x @ ws.pop(0)
            if has_bias:
                head = head + ws.pop(0)
            head_lp = torch.log_softmax(head, -1)
            pieces = [head_lp[:, :cut[0]]]
            for i in range(self.n_clusters):
                w1, w2 = ws.pop(0), ws.pop(0)
                tail_lp = torch.log_softmax((x @ w1) @ w2, -1)
                pieces.append(head_lp[:, cut[0] + i][:, None] + tail_lp)
            return torch.cat(pieces, -1)

        return call_op(fn, input, *params, op_name="adaptive_log_softmax")

    def forward(self, input, label):
        lp = self._log_probs(input)
        out = call_op(lambda v, y: v.gather(
            1, y.reshape(-1, 1).to(torch.long))[:, 0], lp, label,
            op_name="adaptive_pick")
        return out, T.mean(-out)

    def log_prob(self, input):
        return self._log_probs(input)

    def predict(self, input):
        return T.argmax(self._log_probs(input), axis=-1)
