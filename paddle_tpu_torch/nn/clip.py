"""Gradient clipping configurations (reference: ``paddle_tpu/nn/__init__.py``
``ClipGradByGlobalNorm``, ``ClipGradByNorm``, ``ClipGradByValue``).

Each is a configuration that an optimizer reads from its ``grad_clip``
(``Optimizer._clip_cfg``), as in the reference. The eager
``Optimizer.step()`` clips the parameters' gradients, ``TrainStep``
the flat gradient buckets, before the update; ``clip_grads`` does the
work for both:

- by global norm: one scale for every gradient, ``min(1, c / max(norm,
  1e-12))`` with ``norm`` the square root of the sum of every gradient's
  fp32 sum of squares;
- by norm: the same per gradient (per parameter);
- by value: each element clamped to ``[min, max]``.

The scale is cast to the gradient's dtype before the multiply.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grads"]


class ClipGradByGlobalNorm:
    """Gradient clipping by global norm (reference: fluid/clip.py
    GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"


class ClipGradByNorm:
    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)


class ClipGradByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


def _sq(g: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares of ``g``."""
    return torch.sum(torch.square(g.to(torch.float32)))


def _scale(norm: torch.Tensor, c: float) -> torch.Tensor:
    return torch.clamp(c / torch.clamp(norm, min=1e-12), max=1.0)


@torch.no_grad()
def clip_grads(grads: Sequence[torch.Tensor], cfg: Tuple,
               groups: Sequence[Sequence[Tuple[int, int]]] = None
               ) -> None:
    """Clip ``grads`` in place by ``cfg``, ``Optimizer._clip_cfg()``'s
    ``(kind, value)``. By default each tensor of ``grads`` is one
    parameter's gradient. ``groups`` lays parameters out in flat
    tensors instead: ``groups[i]`` lists the ``(offset, numel)`` of each
    parameter inside ``grads[i]``, so "by norm" scales each segment by
    its own norm (the global norm and the value clip read the tensors
    whole)."""
    kind, val = cfg
    if kind == "value":
        lo, hi = val
        for g in grads:
            g.clamp_(lo, hi)
        return
    if kind == "global_norm":
        norm = torch.sqrt(sum(_sq(g) for g in grads))
        scale = _scale(norm, val)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        return
    if kind != "norm":
        raise ValueError(f"unknown clip kind {kind!r}")
    segments: List[torch.Tensor] = []
    for i, g in enumerate(grads):
        if groups is None:
            segments.append(g)
        else:
            segments.extend(g[off:off + n] for off, n in groups[i])
    for seg in segments:
        seg.mul_(_scale(torch.sqrt(_sq(seg)), val).to(seg.dtype))
