"""Tensor ops that the reference dispatches as ops of their own, with its
op names, so that amp casts their inputs as the reference does
(reference: ``paddle_tpu/tensor/math.py`` ``add``,
``tensor/manipulation.py`` ``reshape``/``flatten``/``unsqueeze``,
``tensor/creation.py`` ``zeros_like``, ``tensor/search.py`` ``where``,
``tensor/logic.py`` ``less_than``, and ``framework/tensor.py``
``Tensor.clone``/``__getitem__``).

Only the ops on BERT's and ResNet's paths are here: the residual and
embedding adds, the head reshapes, ResNet's ``x.flatten(1)`` before its
classifier, dropout's identity clone, the pooler's first token,
the MLM labels' ``where(lbl < 0, -1, lbl)``, the position ids'
``unsqueeze`` and the token types' ``zeros_like`` (which the reference
dispatches without an op name: its cast point is named ""). With no amp
active each is the plain PyTorch op and ``clone`` returns its input
(nothing writes to it in place).
"""
from __future__ import annotations

import torch

from ..amp import amp_state, cast

__all__ = ["add", "reshape", "flatten", "clone", "getitem", "where",
           "less_than", "unsqueeze", "zeros_like"]


def add(x, y):
    x, y = cast("add", x, y)
    return x + y


def reshape(x, shape):
    (x,) = cast("reshape", x)
    return x.reshape(shape)


def flatten(x, start_axis: int = 0, stop_axis: int = -1):
    """Axes ``start_axis``..``stop_axis`` (inclusive) merged into one."""
    (x,) = cast("flatten", x)
    return x.flatten(start_axis, stop_axis)


def clone(x):
    (x,) = cast("clone", x)
    return x


def getitem(x, idx):
    (x,) = cast("getitem", x)
    return x[idx]


def _scalar_like(v, x) -> torch.Tensor:
    """``v`` as the 0-dim host tensor the reference makes of a scalar
    operand (on the host: no launch on the card)."""
    return torch.tensor(v, dtype=x.dtype)


def less_than(x, y):
    """``x < y``; a Python scalar ``y`` becomes a 0-dim tensor of x's
    dtype at the cast point, as the reference's operator makes it."""
    if isinstance(y, torch.Tensor):
        x, y = cast("less_than", x, y)
    elif amp_state() is not None:
        x, _ = cast("less_than", x, _scalar_like(y, x))
    return x < y


def where(condition, x, y):
    """``torch.where``; a Python scalar ``x`` counts as a 0-dim tensor of
    y's dtype at the cast point."""
    if isinstance(x, torch.Tensor):
        condition, x, y = cast("where", condition, x, y)
    elif amp_state() is not None:
        condition, _, y = cast("where", condition, _scalar_like(x, y), y)
    return torch.where(condition, x, y)


def unsqueeze(x, axis: int):
    (x,) = cast("unsqueeze", x)
    return x.unsqueeze(axis)


def zeros_like(x):
    (x,) = cast("", x)
    return torch.zeros_like(x)
