"""Normalisation functionals (reference:
``paddle_tpu/nn/functional/norm.py``: ``layer_norm`` and ``batch_norm``,
lines 16-98; ``instance_norm``, ``group_norm`` and
``local_response_norm``, lines 100-179).

``layer_norm`` is a cast point of ``amp`` under "layer_norm" (on the
black list: bf16 inputs are cast to fp32).

``batch_norm`` is the reference's, not PyTorch's training-mode batch
norm, which differs from it twice:

- the batch statistics are constants. The reference computes them in an
  op of their own ("bn_stats") on ``x.detach()``, so no gradient flows
  through the mean and variance: the gradient of ``x`` is ``w *
  rsqrt(var + eps)`` times the upstream gradient, where PyTorch's
  subtracts its projections on the mean and on ``x - mean``;
- the running variance moves toward the biased batch variance
  (``jnp.var``), ``momentum * running + (1 - momentum) * batch``, where
  PyTorch's moves toward the unbiased one with ``1 - momentum``.

In training: the batch mean and biased variance in fp32 from the
detached input, under the cast point "bn_stats" (on neither amp list:
under O2 it sees the bf16 input); the running buffers updated in place
under ``no_grad``, in the buffers' dtype; then the normalisation
``(x_f32 - mean) * rsqrt(var + eps)`` cast to x's dtype, then ``* w +
b``, under the cast point "batch_norm" (black list: fp32 under O2), with
x, the two statistics, w and b as its inputs in the reference's order.
In eval mode, or with ``use_global_stats``, the statistics are the
running buffers and nothing is updated.
"""
from __future__ import annotations

import torch

from ...amp import cast

__all__ = ["layer_norm", "batch_norm", "instance_norm", "group_norm",
           "local_response_norm"]


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-05, name=None) -> torch.Tensor:
    """Normalise over the trailing ``normalized_shape`` axes in fp32, in
    the reference's order: ``(x - mean) * rsqrt(var + eps)``, cast back
    to ``x.dtype``, then ``* weight + bias``."""
    ns = (normalized_shape if isinstance(normalized_shape, (list, tuple))
          else [normalized_shape])
    axes = tuple(range(-len(ns), 0))
    x, *wb = cast("layer_norm", x, *(t for t in (weight, bias)
                                     if t is not None))
    if weight is not None:
        weight = wb.pop(0)
    if bias is not None:
        bias = wb.pop(0)
    v = x.to(torch.float32)
    mean = v.mean(axes, keepdim=True)
    var = v.var(axes, keepdim=True, unbiased=False)
    out = ((v - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-05, data_format: str = "NCHW",
               use_global_stats=None, name=None) -> torch.Tensor:
    """Batch normalisation over every axis but the channel's (axis 1 for
    "NC..." formats, else the last), with the reference's semantics
    (module docstring). ``running_mean`` and ``running_var`` are updated
    in place in training."""
    channel = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != channel)
    bshape = [1] * x.dim()
    bshape[channel] = x.shape[channel]
    if training and not use_global_stats:
        (v,) = cast("bn_stats", x.detach())
        v = v.to(torch.float32)
        mean = v.mean(axes)
        var = v.var(axes, unbiased=False)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean
                               + (1.0 - momentum) * mean)
            running_var.copy_(momentum * running_var
                              + (1.0 - momentum) * var)
    else:
        mean, var = running_mean, running_var
    wb = [t for t in (weight, bias) if t is not None]
    x, mean, var, *wb = cast("batch_norm", x, mean, var, *wb)
    m = mean.reshape(bshape).to(torch.float32)
    s = var.reshape(bshape).to(torch.float32)
    out = ((x.to(torch.float32) - m) * torch.rsqrt(s + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * wb.pop(0).reshape(bshape)
    if bias is not None:
        out = out + wb.pop(0).reshape(bshape)
    return out


def _affine(out, wb, weight, bias, shape):
    if weight is not None:
        out = out * wb.pop(0).reshape(shape)
    if bias is not None:
        out = out + wb.pop(0).reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each sample's channels normalised over their spatial axes, in fp32
    (biased variance, gradients through the statistics), then ``* w +
    b``. As in the reference, the running statistics, ``momentum`` and
    ``use_input_stats`` are taken and not used."""
    channel = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = (tuple(range(2, x.dim())) if channel == 1
            else tuple(range(1, x.dim() - 1)))
    x, *wb = cast("instance_norm", x, *(t for t in (weight, bias)
                                        if t is not None))
    v = x.to(torch.float32)
    mean = v.mean(axes, keepdim=True)
    var = v.var(axes, keepdim=True, unbiased=False)
    out = ((v - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    shape = [1] * x.dim()
    shape[channel] = x.shape[channel]
    return _affine(out, wb, weight, bias, shape)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Channels in ``num_groups`` groups, each normalised over its channels
    and the spatial axes in fp32, then ``* w + b`` a channel."""
    channel = 1 if data_format.startswith("NC") else x.dim() - 1
    x, *wb = cast("group_norm", x, *(t for t in (weight, bias)
                                      if t is not None))
    v = x.movedim(channel, 1) if channel != 1 else x
    n, c = v.shape[:2]
    g = v.reshape(n, num_groups, c // num_groups, *v.shape[2:])
    axes = tuple(range(2, g.dim()))
    gf = g.to(torch.float32)
    mean = gf.mean(axes, keepdim=True)
    var = gf.var(axes, keepdim=True, unbiased=False)
    out = ((gf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    out = out.reshape(v.shape)
    shape = [1] * out.dim()
    shape[1] = c
    out = _affine(out, wb, weight, bias, shape)
    return out.movedim(1, channel) if channel != 1 else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha / size * sum(x^2))^beta``, the sum over the
    ``size`` channels around each (``size // 2`` before it)."""
    (x,) = cast("local_response_norm", x)
    channel = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = x * x
    c = x.shape[channel]
    half = size // 2
    acc = torch.zeros_like(x)
    for offset in range(-half, size - half):
        lo, hi = max(0, -offset), min(c, c - offset)
        if hi <= lo:
            continue
        acc.narrow(channel, lo + offset, hi - lo).add_(
            sq.narrow(channel, lo, hi - lo))
    return x / torch.pow(k + (alpha / size) * acc, beta)
