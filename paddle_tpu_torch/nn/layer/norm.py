"""Normalisation layers (reference: ``paddle_tpu/nn/layer/norm.py``
``_BatchNormBase``, ``BatchNorm``, ``BatchNorm1D/2D/3D`` (lines 13-55)
and ``LayerNorm``; ``SyncBatchNorm`` with ``convert_sync_batchnorm``,
``GroupNorm``, ``InstanceNorm1D/2D/3D``, ``LocalResponseNorm`` and
``SpectralNorm``, lines 58-181).

A batch norm's weight starts at 1 and its bias at 0; its running
statistics are fp32 buffers under the reference's names, ``_mean``
(zeros) and ``_variance`` (ones), so ``state_dict`` keys match. The
functional (``nn/functional/norm.py`` ``batch_norm``) moves them in
place in training, ``momentum * running + (1 - momentum) * batch``.
``BatchNorm``, ``BatchNorm1D``, ``BatchNorm2D`` and ``BatchNorm3D`` are
the same layer, as in the reference (the channel axis is 1 in every
"NC..." format, whatever the rank). So is ``SyncBatchNorm`` in one
process, as the reference's eager one is (the cross-replica statistics
wait for ROADMAP Queue A 10); ``convert_sync_batchnorm`` swaps every
batch norm of a layer tree for one with its weights and statistics.

``GroupNorm`` holds ``weight``/``bias`` (none where the attr is
False), an instance norm ``scale``/``bias`` (the reference's names;
neither where ``weight_attr`` is False), and as in the reference the
instance norms pass only ``epsilon`` to ``F.instance_norm``.
``SpectralNorm`` raises, as the reference's does."""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .common import _make_param
from .layers import Layer, param_device

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


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


class SyncBatchNorm(_BatchNormBase):
    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if (isinstance(layer, _BatchNormBase)
                and not isinstance(layer, SyncBatchNorm)):
            dev = layer._buffers["_mean"].device
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format, device=dev)
            with torch.no_grad():
                for src, dst in ((layer._parameters, out._parameters),
                                 (layer._buffers, out._buffers)):
                    for k, v in src.items():
                        dst[k].copy_(v)
        for name, sub in list(layer._modules.items()):
            out._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


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


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        _ones_zeros(self, [num_channels], weight_attr, bias_attr, device)

    def forward(self, x):
        p = self._parameters
        return F.group_norm(x, self._num_groups, self._epsilon,
                            p.get("weight"), p.get("bias"),
                            self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False:
            self.scale = _make_param(self, [num_features], weight_attr,
                                     device,
                                     default_initializer=I.Constant(1.0))
            self.bias = _make_param(self, [num_features], bias_attr, device,
                                    is_bias=True,
                                    default_initializer=I.Constant(0.0))

    def forward(self, x):
        p = self._parameters
        return F.instance_norm(x, weight=p.get("scale"), bias=p.get("bias"),
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        raise NotImplementedError("SpectralNorm lands with the GAN op "
                                  "family, as in the reference")
