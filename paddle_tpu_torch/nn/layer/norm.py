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

from .. import functional as F
from .. import initializer as I
from .common import _make_param
from .layers import Layer, param_device

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm"]


def _ones_zeros(layer, shape, weight_attr, bias_attr, device):
    """A norm's weight (ones) and bias (zeros), or what the attrs say."""
    layer.weight = _make_param(layer, shape, weight_attr, device,
                               default_initializer=I.Constant(1.0))
    layer.bias = _make_param(layer, shape, bias_attr, device, is_bias=True,
                             default_initializer=I.Constant(0.0))


class _BatchNormBase(Layer):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-05, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, *, device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = param_device(device)
        _ones_zeros(self, [num_features], weight_attr, bias_attr, device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        p, b = self._parameters, self._buffers
        return F.batch_norm(x, b["_mean"], b["_variance"], p.get("weight"),
                            p.get("bias"), training=self.training,
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


class LayerNorm(Layer):
    """Weight ones, bias zeros, ``epsilon`` 1e-5 unless given
    (``norm.py:80``)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _ones_zeros(self, self._normalized_shape, weight_attr, bias_attr,
                    device)

    def forward(self, x):
        p = self._parameters
        return F.layer_norm(x, self._normalized_shape, p.get("weight"),
                            p.get("bias"), self._epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")
