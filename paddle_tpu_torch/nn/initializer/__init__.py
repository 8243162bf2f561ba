"""Weight initializers (reference: ``paddle_tpu/nn/initializer/__init__.py``).

Each initializer is called on a parameter (an eager ``Parameter`` or its
``torch.Tensor`` payload) and overwrites its values in place, drawing
from the global stream's generator of the parameter's device
(``framework/random.py``), so ``paddle.seed(s)`` makes a layer's
parameters repeat on that device. The distributions, fans and gains are
the reference's: a draw in fp32 cast to the parameter's dtype, fans
``[in, out]`` for a 2-D weight (Paddle's ``Linear`` layout) and ``[out,
in / groups, *kernel]`` for a convolution's. The values are not the
reference's (its threefry bits cannot be reproduced): a test holds
their ranges and moments.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...framework import random as rng
from ...framework.autograd import unwrap

__all__ = ["Initializer", "Constant", "Uniform", "Normal",
           "TruncatedNormal", "XavierUniform", "XavierNormal",
           "KaimingUniform", "KaimingNormal", "Assign", "Orthogonal",
           "Dirac", "Bilinear", "calculate_gain", "set_global_initializer",
           "global_initializer"]


def _fill(param, values) -> object:
    v = unwrap(param)
    with torch.no_grad():
        v.copy_(torch.as_tensor(values).to(v.device, v.dtype).reshape(
            v.shape))
    return param


def _gen(v: torch.Tensor) -> torch.Generator:
    return rng.generator_for(v.device)


def _uniform(v, lo, hi) -> torch.Tensor:
    out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    return out.uniform_(lo, hi, generator=_gen(v))


def _normal(v) -> torch.Tensor:
    return torch.randn(v.shape, dtype=torch.float32, device=v.device,
                       generator=_gen(v))


class Initializer:
    def __call__(self, param, block=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, block=None):
        with torch.no_grad():
            unwrap(param).fill_(self.value)
        return param


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, param, block=None):
        v = unwrap(param)
        return _fill(param, _uniform(v, self.low, self.high))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        v = unwrap(param)
        return _fill(param, _normal(v) * self.std + self.mean)


class TruncatedNormal(Initializer):
    """N(0, 1) truncated to [-2, 2], by the inverse CDF of a uniform
    draw (as ``jax.random.truncated_normal``), scaled and shifted."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        v = unwrap(param)
        lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
        u = _uniform(v, lo, hi)
        z = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -2.0, 2.0)
        return _fill(param, z * self.std + self.mean)


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        v = unwrap(param)
        fi, fo = _fans(tuple(v.shape))
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return _fill(param, _uniform(v, -limit, limit))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        v = unwrap(param)
        fi, fo = _fans(tuple(v.shape))
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return _fill(param, _normal(v) * std)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, param, block=None):
        v = unwrap(param)
        fi = self.fan_in or _fans(tuple(v.shape))[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _fill(param, _uniform(v, -limit, limit))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, param, block=None):
        v = unwrap(param)
        fi = self.fan_in or _fans(tuple(v.shape))[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _fill(param, _normal(v) * (gain / math.sqrt(fi)))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, param, block=None):
        val = unwrap(self.value)
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.asarray(val))
        return _fill(param, val)


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal``: the Q of a normal draw's QR,
    its columns' signs fixed by R's diagonal, times ``gain``."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, param, block=None):
        v = unwrap(param)
        shape = tuple(v.shape)
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
        a = torch.randn(mshape, dtype=torch.float32, device=v.device,
                        generator=_gen(v))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return _fill(param, self.gain * q.reshape(shape))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, param, block=None):
        shape = tuple(unwrap(param).shape)
        arr = np.zeros(shape, dtype=np.float32)
        centers = [k // 2 for k in shape[2:]]
        for i in range(min(shape[0], shape[1] * self.groups)):
            arr[(i, i % shape[1]) + tuple(centers)] = 1.0
        return _fill(param, torch.from_numpy(arr))


class Bilinear(Initializer):
    """The bilinear-interpolation kernel of a transposed convolution's
    upsampling (the reference's ``BilinearInitializer``)."""

    def __call__(self, param, block=None):
        shape = tuple(unwrap(param).shape)
        if len(shape) != 4:
            raise ValueError("Bilinear init expects a 4-D conv weight")
        kh, kw = shape[2], shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2

        def tri(k, f):
            c = (2 * f - 1 - f % 2) / (2.0 * f)
            return 1 - np.abs(np.arange(k) / f - c)

        filt = np.outer(tri(kh, fh), tri(kw, fw)).astype(np.float32)
        arr = np.zeros(shape, np.float32)
        for i in range(min(shape[0], shape[1])):
            arr[i, i] = filt
        return _fill(param, torch.from_numpy(arr))


def calculate_gain(nonlinearity, param=None):
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None
                                            else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in recommended:
        raise ValueError(f"Unknown nonlinearity {nonlinearity}")
    return recommended[nonlinearity]


_GLOBAL = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """``paddle.nn.initializer.set_global_initializer``: the initializers
    of parameters whose layer names none and whose attr names none."""
    _GLOBAL["weight"] = weight_init
    _GLOBAL["bias"] = bias_init


def global_initializer(is_bias):
    return _GLOBAL["bias" if is_bias else "weight"]
