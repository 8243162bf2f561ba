"""Activations (reference: ``paddle_tpu/nn/functional/activation.py``
``gelu``, ``relu``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu", "relu"]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU, exact (erf) unless ``approximate`` (tanh), as
    ``jax.nn.gelu(approximate=...)``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)
