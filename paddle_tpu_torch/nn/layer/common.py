"""Common layers (reference: ``paddle_tpu/nn/layer/common.py`` ``Linear``,
``Embedding``, ``Dropout``, ``Flatten``).

``Linear`` keeps Paddle's weight layout ``[in_features, out_features]``
(``y = x @ W + b``), so the reference's weights copy over unchanged and a
per-column scale is a per-output-channel scale. ``torch.nn.Linear``
stores ``[out, in]`` and is not used. Each ``Linear`` carries the name
the reference gives its weight (``linear_<N>.w_0``, numbered in creation
order, ``nn/layer/layers.py:118-127``) as ``weight_name``; it rides the
module's ``state_dict`` as extra state, so weights loaded from the
reference (``models/convert.py``) bring the reference's names along and
``stable_seed(weight_name)`` gives both sides the same stochastic
rounding seed.

Parameters are drawn from a numpy ``RandomState`` (``rs``; numpy's
global generator when none is given), with the reference's
initialisers: Xavier-uniform weights and zero biases for ``Linear``,
standard-normal rows for ``Embedding``.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import tensor as T
from ...framework.device import resolve_device
from .. import functional as F
from ..functional.common import OPTIONS_ITEM, check_dropout_options

__all__ = ["Linear", "Embedding", "Dropout", "Flatten"]

_LINEAR_IDS = itertools.count()


def _param(arr: np.ndarray, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(arr.astype(np.float32)).to(device))


def _check_attr(name: str, attr) -> None:
    if attr is not None and attr is not False:
        raise NotImplementedError(f"{name}={attr!r}: ParamAttr is not ported "
                                  f"(None or False only)")


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` as ``[in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, *, device="cuda",
                 rs: Optional[np.random.RandomState] = None):
        super().__init__()
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        dev = resolve_device(device)
        rs = np.random if rs is None else rs
        limit = math.sqrt(6.0 / (in_features + out_features))
        self.weight = _param(rs.uniform(-limit, limit,
                                        (in_features, out_features)), dev)
        self.bias = (None if bias_attr is False
                     else _param(np.zeros(out_features), dev))
        self.weight_name = f"linear_{next(_LINEAR_IDS)}.w_0"

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def get_extra_state(self):
        return {"weight_name": self.weight_name}

    def set_extra_state(self, state) -> None:
        """Take a carried weight name; ``None`` keeps this one."""
        if state and state.get("weight_name"):
            self.weight_name = state["weight_name"]

    def extra_repr(self) -> str:
        return (f"in_features={self.weight.shape[0]}, "
                f"out_features={self.weight.shape[1]}")


class Embedding(nn.Module):
    """Lookup table ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, *,
                 device="cuda", rs: Optional[np.random.RandomState] = None):
        super().__init__()
        _check_attr("weight_attr", weight_attr)
        if padding_idx is not None or sparse:
            raise NotImplementedError(f"Embedding padding_idx/sparse is not "
                                      f"ported yet ({OPTIONS_ITEM})")
        rs = np.random if rs is None else rs
        self.weight = _param(rs.randn(num_embeddings, embedding_dim),
                             resolve_device(device))

    def forward(self, x):
        return F.embedding(x, self.weight)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(nn.Module):
    """Dropout at inference (see ``functional.dropout``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        check_dropout_options(axis, mode)
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)


class Flatten(nn.Module):
    """``paddle_tpu_torch.tensor.flatten`` (the cast point "flatten")."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        return T.flatten(input, self.start_axis, self.stop_axis)
