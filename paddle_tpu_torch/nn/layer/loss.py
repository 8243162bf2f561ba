"""Loss layers (reference: ``paddle_tpu/nn/layer/loss.py`` ``BCELoss`` and
``BCEWithLogitsLoss``, lines 55-74; the others are not ported yet)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["BCELoss", "BCEWithLogitsLoss"]


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)
