"""Convolutions (reference: ``paddle_tpu/nn/functional/conv.py``
``_pair``, ``_padding``, ``_conv``, ``conv1d``/``conv2d``/``conv3d``,
lines 15-80).

The reference lowers a convolution to ``lax.conv_general_dilated`` (no
Pallas kernel); the port calls PyTorch's convolution, cuDNN on the card.
The data is NC[D]HW with OI[D]HW weights (Paddle's default); a
channels-last ``data_format`` (NLC, NHWC, NDHWC) is taken as the
reference takes it, the input moved to channels-first around the call.
Padding takes the reference's forms, read as its ``_padding`` reads
them: an int, one int a spatial axis, (low, high) pairs flattened or
nested, or "SAME"/"VALID" (XLA's: "SAME" gives ``ceil(in / stride)``
outputs, the odd padding high). Uneven padding is applied with
``F.pad`` before the call.

Each is a cast point of ``amp`` under the reference's op name
("conv1d", "conv2d", "conv3d", on the white list). The card's
convolution runs with cuDNN's TF32 off (``framework/precision.py``
``matmul_precision`` for the operands' dtype, ``settings_for``), in the
forward and, through one identity node on the output
(``backward_precision``), in the backward pass that reaches it: an fp32
convolution is an fp32 convolution, as the reference computes it.

The transposed convolutions are not ported: they raise, naming ROADMAP
Queue A 14 ("the rest", the other vision models).
"""
from __future__ import annotations

import torch.nn.functional as F

from ...amp import cast
from ...framework.precision import (backward_precision, matmul_precision,
                                    settings_for)

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "REST_ITEM"]

REST_ITEM = "ROADMAP Queue A 14, 'the rest'"
_TORCH_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _padding(padding, nd):
    """The reference's ``_padding``: a string, or (low, high) a spatial
    axis."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding[-nd:]]
    raise ValueError(f"bad padding {padding}")


def _same_pads(spatial, ksize, stride, dilation):
    """XLA's "SAME" for a convolution or a window: ``ceil(in / stride)``
    outputs, the odd pad high."""
    out = []
    for n, k, s, d in zip(spatial, ksize, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          data_format):
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    last = not data_format.startswith("NC")
    if bias is None:
        x, weight = cast(f"conv{nd}d", x, weight)
    else:
        x, weight, bias = cast(f"conv{nd}d", x, weight, bias)
    if last:
        x = x.movedim(-1, 1)
    pad = _padding(padding, nd)
    if pad == "VALID":
        pad = [(0, 0)] * nd
    elif pad == "SAME":
        pad = _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        x = F.pad(x, [v for lo_hi in reversed(pad) for v in lo_hi])
        sym = 0
    with matmul_precision(settings_for(x.dtype)):
        out = _TORCH_CONV[nd](x, weight, bias, stride, sym, dilation, groups)
    out = backward_precision(settings_for(x.dtype), out)
    return out.movedim(1, -1) if last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _transpose_not_ported(nd):
    raise NotImplementedError(f"conv{nd}d_transpose is not ported yet "
                              f"({REST_ITEM})")


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    _transpose_not_ported(1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    _transpose_not_ported(2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    _transpose_not_ported(3)
