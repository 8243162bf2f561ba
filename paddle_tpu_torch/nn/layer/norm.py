"""Normalisation layers (reference: ``paddle_tpu/nn/layer/norm.py``
``_BatchNormBase``, ``BatchNorm``, ``BatchNorm1D/2D/3D`` (lines 13-55)
and ``LayerNorm``; the other norms are not ported yet).

A batch norm's weight starts at 1 and its bias at 0; its running
statistics are fp32 buffers under the reference's names, ``_mean``
(zeros) and ``_variance`` (ones), so ``state_dict`` keys match. The
functional (``nn/functional/norm.py`` ``batch_norm``) moves them in
place in training, ``momentum * running + (1 - momentum) * batch``.
``BatchNorm``, ``BatchNorm1D``, ``BatchNorm2D`` and ``BatchNorm3D`` are
the same layer, as in the reference (the channel axis is 1 in every
"NC..." format, whatever the rank)."""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .common import _check_attr

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm"]


class _BatchNormBase(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-05, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, *, device="cuda"):
        super().__init__()
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        self.weight = (None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, device=dev)))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, device=dev)))
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


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
