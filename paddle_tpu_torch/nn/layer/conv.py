"""Convolution layers (reference: ``paddle_tpu/nn/layer/conv.py``
``_ConvNd``, ``Conv1D``, ``Conv2D``, ``Conv3D``, lines 18-90).

Weights ``[out, in / groups, *kernel]`` from ``KaimingUniform(fan_in)``
(limit ``sqrt(6 / fan_in)``, the gain of a leaky ReLU of slope 0), the
bias ``[out]`` from ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``,
``fan_in = in / groups * prod(kernel)``; ``bias_attr=False`` means no
bias. Padding is zeros whatever ``padding_mode`` says, as in the
reference. The values are drawn from a numpy ``RandomState`` (``rs``; numpy's
global generator when none is given), as ``nn/layer/common.py`` draws
``Linear``'s: not the reference's draws (it seeds from Paddle's
generator), so weights are carried across with ``models/convert.py``.
The transposed layers are not ported (``nn/functional/conv.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .common import _check_attr, _param

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _ConvNd(nn.Module):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device="cuda", rs: Optional[np.random.RandomState] = None):
        super().__init__()
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, nd)
        self._stride = _ntuple(stride, nd)
        self._padding = padding
        self._dilation = _ntuple(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        dev = resolve_device(device)
        rs = np.random if rs is None else rs
        shape = (out_channels, in_channels // groups) + self._kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        limit = np.sqrt(6.0 / fan_in)
        self.weight = _param(rs.uniform(-limit, limit, shape), dev)
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = (None if bias_attr is False else
                     _param(rs.uniform(-bound, bound, out_channels), dev))

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={list(self._stride)}")


class Conv1D(_ConvNd):
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)


class Conv2D(_ConvNd):
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)


class Conv3D(_ConvNd):
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **kw):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **kw)
