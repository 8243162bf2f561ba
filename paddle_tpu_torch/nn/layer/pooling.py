"""Pooling layers (reference: ``paddle_tpu/nn/layer/pooling.py``
``MaxPool2D``, ``AvgPool2D``, ``AdaptiveAvgPool2D``, lines 27-114).

As in the reference, ``MaxPool2D`` and ``AvgPool2D`` pass on the window,
stride, padding and data format only: ``return_mask``, ``ceil_mode``,
``exclusive`` and ``divisor_override`` are taken and not used.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class _Pool(nn.Module):
    def __init__(self, fn, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self._fn = fn
        self._args = dict(kw)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        **self._args)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         data_format=data_format)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         data_format=data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)
