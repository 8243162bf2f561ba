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

Each is a ``Layer`` (``nn/layer/layers.py``). Its parameters take the
reference's default initialisers (Xavier-uniform weights and zero
biases for ``Linear``, standard-normal rows for ``Embedding``), or what
``weight_attr``/``bias_attr`` (``ParamAttr``) say, drawn from the
global stream (``paddle.seed``). With ``rs``, a numpy ``RandomState``,
the values are drawn from it instead, as the port's models draw theirs
(``_make_param``); an attr's name, learning rate, regularizer,
trainable and need_clip apply either way. New parameters go to
``device``, or to the current place.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ... import tensor as T
from ...framework.param_attr import ParamAttr
from ...framework.tensor import Parameter
from .. import functional as F
from .. import initializer as I
from ..functional.common import OPTIONS_ITEM, check_dropout_options
from .layers import Layer, param_device, unique_name

__all__ = ["Linear", "Embedding", "Dropout", "Flatten"]

_LINEAR_IDS = itertools.count()


def _make_param(layer: Layer, shape, attr, device, *, is_bias=False,
                default_initializer=None,
                draw: Optional[Callable[[], np.ndarray]] = None):
    """``layer.create_parameter``; with ``draw`` (the caller's numpy
    ``RandomState`` draw, ``None`` without ``rs``) the parameter holds
    the drawn fp32 values instead of the initializer's. None when
    ``attr`` is False."""
    if draw is None:
        return layer.create_parameter(shape, attr, is_bias=is_bias,
                                      default_initializer=default_initializer,
                                      device=device)
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    arr = np.asarray(draw(), dtype=np.float64).astype(np.float32)
    p = Parameter(torch.from_numpy(arr).to(param_device(device)),
                  name=attr.name or unique_name(
                      f"{layer.full_name()}.{'b' if is_bias else 'w'}"),
                  trainable=attr.trainable)
    if attr.initializer is not None:
        attr.initializer(p)
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


class Linear(Layer):
    """``y = x @ W + b`` with ``W`` as ``[in_features, out_features]``."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 rs: Optional[np.random.RandomState] = None):
        super().__init__()
        k = next(_LINEAR_IDS)
        self._full_name = f"linear_{k}"
        self.weight_name = f"linear_{k}.w_0"
        limit = math.sqrt(6.0 / (in_features + out_features))
        if weight_attr is None:
            weight_attr = ParamAttr(name=self.weight_name)
        self.weight = _make_param(
            self, [in_features, out_features], weight_attr, device,
            default_initializer=I.XavierUniform(),
            draw=None if rs is None else lambda: rs.uniform(
                -limit, limit, (in_features, out_features)))
        self.bias = _make_param(
            self, [out_features], bias_attr, device, is_bias=True,
            draw=None if rs is None else lambda: np.zeros(out_features))

    def forward(self, x):
        p = self._parameters
        return F.linear(x, p.get("weight"), p.get("bias"))

    def get_extra_state(self):
        return {"weight_name": self.weight_name}

    def set_extra_state(self, state) -> None:
        """Take a carried weight name; ``None`` keeps this one."""
        if state and state.get("weight_name"):
            self.weight_name = state["weight_name"]

    def extra_repr(self) -> str:
        return (f"in_features={self.weight.shape[0]}, "
                f"out_features={self.weight.shape[1]}")


class Embedding(Layer):
    """Lookup table ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None,
                 name=None, *, device=None,
                 rs: Optional[np.random.RandomState] = None):
        super().__init__()
        if padding_idx is not None or sparse:
            raise NotImplementedError(f"Embedding padding_idx/sparse is not "
                                      f"ported yet ({OPTIONS_ITEM})")
        self.weight = _make_param(
            self, [num_embeddings, embedding_dim], weight_attr, device,
            default_initializer=I.Normal(0.0, 1.0),
            draw=None if rs is None else lambda: rs.randn(num_embeddings,
                                                          embedding_dim))

    def forward(self, x):
        return F.embedding(x, self._parameters["weight"])

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(Layer):
    """Dropout at inference (see ``functional.dropout``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        check_dropout_options(axis, mode)
        self.p = p

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training)


class Flatten(Layer):
    """``paddle_tpu_torch.tensor.flatten`` (the cast point "flatten")."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        return T.flatten(input, self.start_axis, self.stop_axis)
