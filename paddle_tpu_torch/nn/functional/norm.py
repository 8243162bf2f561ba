"""Layer and batch normalisation (reference:
``paddle_tpu/nn/functional/norm.py`` ``layer_norm`` and ``batch_norm``,
lines 16-98).

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

__all__ = ["layer_norm", "batch_norm"]


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-05) -> torch.Tensor:
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
               use_global_stats=None) -> torch.Tensor:
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
