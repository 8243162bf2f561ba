"""Layer normalisation (reference: ``paddle_tpu/nn/layer/norm.py``
``LayerNorm``; the other norms are not ported yet)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """Weight ones, bias zeros, ``epsilon`` 1e-5 unless given
    (``norm.py:80``)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device="cuda"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(self._normalized_shape, device=dev)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(self._normalized_shape, device=dev)))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")
