"""Layer normalisation (reference: ``paddle_tpu/nn/functional/norm.py``
``layer_norm``), a cast point of ``amp`` under "layer_norm" (on the
black list: bf16 inputs are cast to fp32)."""
from __future__ import annotations

import torch

from ...amp import cast

__all__ = ["layer_norm"]


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
