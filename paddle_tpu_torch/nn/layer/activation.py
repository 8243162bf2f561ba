"""Activation layers (reference: ``paddle_tpu/nn/layer/activation.py``):
the 26 layers. Each but ``PReLU`` is the reference's ``_simple`` layer
over its functional: it takes the functional's options positionally or
by name, in the order the reference declares them, and forwards them.
``PReLU`` holds ``weight`` (``[num_parameters]``, ``Constant(init)`` or
what ``weight_attr`` says)."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["CELU", "ELU", "GELU", "Hardshrink", "Hardsigmoid", "Hardswish",
           "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout",
           "Mish", "PReLU", "ReLU", "ReLU6", "SELU", "Sigmoid", "Silu",
           "Softmax", "Softplus", "Softshrink", "Softsign", "Swish", "Tanh",
           "Tanhshrink", "ThresholdedReLU"]


def _simple(name, fn, **default_kw):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kw = dict(default_kw)
            for k, v in zip(default_kw, args):
                kw[k] = v
            for k in default_kw:
                if k in kwargs:
                    kw[k] = kwargs[k]
            self._kw = kw

        def forward(self, x):
            return fn(x, **self._kw)

    _Act.__name__ = name
    _Act.__qualname__ = name
    _Act.__doc__ = f"``F.{fn.__name__}`` as a layer."
    return _Act


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
GELU = _simple("GELU", F.gelu, approximate=False)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Tanh = _simple("Tanh", F.tanh)
LeakyReLU = _simple("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = _simple("ELU", F.elu, alpha=1.0)
SELU = _simple("SELU", F.selu)
CELU = _simple("CELU", F.celu, alpha=1.0)
Silu = _simple("Silu", F.silu)
Swish = _simple("Swish", F.swish)
Mish = _simple("Mish", F.mish)
Hardswish = _simple("Hardswish", F.hardswish)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Hardtanh = _simple("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Hardshrink = _simple("Hardshrink", F.hardshrink, threshold=0.5)
Softshrink = _simple("Softshrink", F.softshrink, threshold=0.5)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
Softplus = _simple("Softplus", F.softplus, beta=1.0, threshold=20.0)
Softsign = _simple("Softsign", F.softsign)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
ThresholdedReLU = _simple("ThresholdedReLU", F.thresholded_relu,
                          threshold=1.0)
Softmax = _simple("Softmax", F.softmax, axis=-1)
LogSoftmax = _simple("LogSoftmax", F.log_softmax, axis=-1)
Maxout = _simple("Maxout", F.maxout, groups=2, axis=1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init), device=device)

    def forward(self, x):
        return F.prelu(x, self._parameters["weight"], self._data_format)
