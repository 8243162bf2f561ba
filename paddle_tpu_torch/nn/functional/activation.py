"""Activations (reference: ``paddle_tpu/nn/functional/activation.py``),
all 30 of its functions, each a cast point of ``amp`` under the
reference's op name.

The formulas and constants are the reference's (``jax.nn``'s), not
PyTorch's functions of the same name where the two differ:

- a kink takes the reference's gradient. ``leaky_relu`` and ``prelu``
  are ``where(x >= 0, x, a x)`` (slope 1 at 0, where PyTorch's
  ``leaky_relu`` gives ``a``); a clip is ``minimum(maximum(x, lo),
  hi)``, half the gradient at a bound (``hardtanh``, ``hardswish``,
  ``hardsigmoid``), as ``jnp.clip``; ``celu`` is ``maximum(x, 0) + a
  expm1(minimum(x, 0) / a)``, so its halves meet at 0;
- ``hardsigmoid`` is ``clip(slope x + offset, 0, 1)`` with the
  reference's slope 0.1666667 and offset 0.5 (PyTorch's ``x / 6 +
  1/2``), ``hardswish`` ``x clip(x + 3, 0, 6) / 6``, ``softplus``
  ``where(beta x > threshold, x, log(1 + exp(beta x)) / beta)``,
  ``selu`` ``scale where(x > 0, x, alpha expm1(x))`` at the reference's
  defaults, ``thresholded_relu`` ``where(x > threshold, x, 0)``;
- ``softmax``/``log_softmax`` with ``dtype`` cast the input first (a
  64-bit name narrowed, as the reference holds it);
- ``maxout`` takes the maximum over each group (a tie shares the
  gradient, as ``jnp.max``'s), ``glu`` is ``a * sigmoid(b)`` of the two
  halves along ``axis``;
- ``gumbel_softmax`` draws its noise ``-log(-log(u))`` from the
  generator of the input's device (``framework/random.py``, the stream
  that ``paddle.seed`` governs); ``hard`` is straight-through: one-hot
  rows forward (``y_hard + (y - y.detach())``, exactly one-hot where the
  reference's ``y_hard + y - y`` rounds), the soft rows' gradient.

The in-place forms ``relu_``, ``softmax_``, ``elu_`` and ``tanh_`` take
an eager ``Tensor`` and rebind it to the result (``_replace_from``), as
the reference's do; given a ``torch.Tensor`` they write the result into
it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast
from ...framework import random as rng
from ...framework.dtype import convert_dtype

__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax", "hardshrink",
           "hardsigmoid", "hardswish", "hardtanh", "leaky_relu",
           "log_sigmoid", "log_softmax", "maxout", "mish", "prelu", "relu",
           "relu6", "selu", "sigmoid", "silu", "softmax", "softplus",
           "softshrink", "softsign", "swish", "tanh", "tanhshrink",
           "thresholded_relu"]


def _scalar(v: torch.Tensor, c: float) -> torch.Tensor:
    return torch.full((), c, dtype=v.dtype, device=v.device)


def clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: half the gradient at a bound."""
    return torch.minimum(torch.maximum(v, _scalar(v, lo)), _scalar(v, hi))


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(v, 0)``."""
    return torch.logaddexp(v, _scalar(v, 0.0))


def gelu(x, approximate=False, name=None):
    """GELU, exact (erf) unless ``approximate`` (tanh), as
    ``jax.nn.gelu(approximate=...)``."""
    (x,) = cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    (x,) = cast("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = cast("relu6", x)
    return F.relu6(x)


def sigmoid(x, name=None):
    (x,) = cast("sigmoid", x)
    return torch.sigmoid(x)


def tanh(x, name=None):
    (x,) = cast("tanh", x)
    return torch.tanh(x)


def _with_dtype(v, dtype):
    return v if dtype is None else v.to(convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast("softmax", x)
    return torch.softmax(_with_dtype(x, dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = cast("log_softmax", x)
    return torch.log_softmax(_with_dtype(x, dtype), dim=axis)


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x >= 0, x, w x)``, one slope or one a channel (axis 1 for
    "NC..." formats, else the last)."""
    x, w = cast("prelu", x, weight)
    if w.numel() == 1:
        w = w.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else x.dim() - 1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def elu(x, alpha=1.0, name=None):
    (x,) = cast("elu", x)
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(
        torch.where(pos, _scalar(x, 0.0), x)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = cast("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = cast("celu", x)
    zero = _scalar(x, 0.0)
    return torch.maximum(x, zero) + alpha * torch.expm1(
        torch.minimum(x, zero) / alpha)


def silu(x, name=None):
    (x,) = cast("silu", x)
    return x * torch.sigmoid(x)


def swish(x, name=None):
    (x,) = cast("swish", x)
    return x * torch.sigmoid(x)


def mish(x, name=None):
    (x,) = cast("mish", x)
    return x * torch.tanh(_softplus(x))


def hardswish(x, name=None):
    (x,) = cast("hardswish", x)
    return x * clip(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    (x,) = cast("hardsigmoid", x)
    return clip(slope * x + offset, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    (x,) = cast("hardtanh", x)
    return clip(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, _scalar(x, 0.0))


def softshrink(x, threshold=0.5, name=None):
    (x,) = cast("softshrink", x)
    zero = _scalar(x, 0.0)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    (x,) = cast("tanhshrink", x)
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = cast("softplus", x)
    return torch.where(beta * x > threshold, x, _softplus(beta * x) / beta)


def softsign(x, name=None):
    (x,) = cast("softsign", x)
    return x / (x.abs() + 1)


def log_sigmoid(x, name=None):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    (x,) = cast("log_sigmoid", x)
    return -_softplus(-x)


def maxout(x, groups, axis=1, name=None):
    (x,) = cast("maxout", x)
    ax = axis + x.dim() if axis < 0 else axis
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(ax + 1)


def thresholded_relu(x, threshold=1.0, name=None):
    (x,) = cast("thresholded_relu", x)
    return torch.where(x > threshold, x, _scalar(x, 0.0))


def glu(x, axis=-1, name=None):
    (x,) = cast("glu", x)
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    (x,) = cast("gumbel_softmax", x)
    tiny = torch.finfo(x.dtype).tiny
    u = torch.rand(x.shape, generator=rng.generator_for(x.device),
                   dtype=x.dtype, device=x.device).clamp_min(tiny)
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + (y - y.detach())
    return y
