"""Activation layers (reference: ``paddle_tpu/nn/layer/activation.py``
``ReLU`` and ``Sigmoid``, lines 30 and 33; the others are not ported
yet)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "Sigmoid"]


class ReLU(nn.Module):
    """``F.relu`` (the cast point "relu")."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Sigmoid(nn.Module):
    """``F.sigmoid`` (the cast point "sigmoid")."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)
