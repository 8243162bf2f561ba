"""Activations (reference: ``paddle_tpu/nn/functional/activation.py``
``gelu``, ``relu``, ``sigmoid``, ``tanh``), each a cast point of ``amp`` under its op
name."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp import cast

__all__ = ["gelu", "relu", "sigmoid", "tanh"]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU, exact (erf) unless ``approximate`` (tanh), as
    ``jax.nn.gelu(approximate=...)``."""
    (x,) = cast("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast("relu", x)
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast("sigmoid", x)
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    (x,) = cast("tanh", x)
    return torch.tanh(x)
