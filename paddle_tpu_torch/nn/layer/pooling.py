"""Pooling layers (reference: ``paddle_tpu/nn/layer/pooling.py``): the
12 layers.

As in the reference, the window layers pass on the window, stride,
padding and (where they take one) data format only: ``return_mask``,
``ceil_mode``, ``exclusive`` and ``divisor_override`` are taken and not
used, and so is the adaptive max layers' ``return_mask``
(``F.max_pool2d(..., return_mask=True)`` and the adaptive functionals
give the mask).
"""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]


class _Pool(Layer):
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


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size, stride, padding)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.max_pool2d, kernel_size, stride, padding,
                         data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(F.max_pool3d, kernel_size, stride, padding,
                         data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size, stride, padding)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__(F.avg_pool2d, kernel_size, stride, padding,
                         data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(F.avg_pool3d, kernel_size, stride, padding,
                         data_format=data_format)


class _Adaptive(Layer):
    def __init__(self, fn, output_size, *args):
        super().__init__()
        self._fn = fn
        self._output_size = output_size
        self._args = args

    def forward(self, x):
        return self._fn(x, self._output_size, *self._args)


class AdaptiveAvgPool1D(_Adaptive):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size)


class AdaptiveAvgPool2D(_Adaptive):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size, data_format)


class AdaptiveAvgPool3D(_Adaptive):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(F.adaptive_avg_pool3d, output_size, data_format)


class AdaptiveMaxPool1D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size)


class AdaptiveMaxPool2D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size)


class AdaptiveMaxPool3D(_Adaptive):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size)
