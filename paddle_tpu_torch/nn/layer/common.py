"""Common layers (reference: ``paddle_tpu/nn/layer/common.py``): every
layer of it, ``HSigmoidLoss`` among them. The dropout
layers draw in training (``functional/common.py``); the others hold
their options and call their functional, as the reference's do.

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
from ..functional.common import OPTIONS_ITEM
from .layers import Layer, param_device, unique_name

__all__ = ["Linear", "Embedding", "Identity", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "CosineSimilarity", "Bilinear",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Unfold",
           "Fold", "PairwiseDistance", "MaxUnPool1D", "MaxUnPool2D",
           "MaxUnPool3D", "HSigmoidLoss"]

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


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout(Layer):
    """``F.dropout`` at ``self.p``, drawing in training."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):
        return F.dropout(input, self.p, self.axis, self.training, self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout2d(input, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, input):
        return F.dropout3d(input, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, self.p, self.training)


class Flatten(Layer):
    """``paddle_tpu_torch.tensor.flatten`` (the cast point "flatten")."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):
        return T.flatten(input, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__()
        self._pad = padding
        self._mode = mode
        self._value = value
        self._data_format = data_format

    def forward(self, x):
        return F.pad(x, self._pad, self._mode, self._value,
                     self._data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis = axis
        self._eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self._axis, self._eps)


class Bilinear(Layer):
    """``weight`` ``[out, in1, in2]`` (Xavier-uniform unless an attr
    says), ``bias`` ``[out]`` (zeros)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features],
            attr=weight_attr, device=device)
        self.bias = self.create_parameter(shape=[out_features],
                                          attr=bias_attr, is_bias=True,
                                          device=device)

    def forward(self, x1, x2):
        p = self._parameters
        return F.bilinear(x1, x2, p["weight"], p.get("bias"))


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = upscale_factor
        self._data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._factor, self._data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = downscale_factor
        self._data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._factor, self._data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._groups = groups
        self._data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._groups, self._data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self._p, self._eps, self._keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self._p, self._eps, self._keepdim)


class _MaxUnPool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, output_size, data_format)

    def forward(self, x, indices):
        return type(self)._fn(x, indices, *self._args)


class MaxUnPool1D(_MaxUnPool):
    _fn = F.max_unpool1d

    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool2D(_MaxUnPool):
    _fn = F.max_unpool2d

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool3D(_MaxUnPool):
    _fn = F.max_unpool3d

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid loss over a layer's node weights
    (``[num_classes - 1, feature_size]``, or ``num_classes`` rows with
    ``is_custom``) and biases; ``is_sparse`` is taken and not used."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        self._num_classes = num_classes
        rows = num_classes if is_custom else max(num_classes - 1, 1)
        self.weight = self.create_parameter([rows, feature_size],
                                            attr=weight_attr)
        self.bias = self.create_parameter([rows], attr=bias_attr,
                                          is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        p = self._parameters
        return F.hsigmoid_loss(input, label, self._num_classes,
                               p["weight"], bias=p.get("bias"),
                               path_table=path_table, path_code=path_code)
