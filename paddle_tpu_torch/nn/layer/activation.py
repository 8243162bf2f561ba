"""Activation layers (reference: ``paddle_tpu/nn/layer/activation.py``
``ReLU`` and ``Sigmoid``, lines 30 and 33; the others are not ported
yet)."""
from __future__ import annotations


from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "Sigmoid"]


class ReLU(Layer):
    """``F.relu`` (the cast point "relu")."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Sigmoid(Layer):
    """``F.sigmoid`` (the cast point "sigmoid")."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)
