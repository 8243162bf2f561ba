"""Pooling (reference: ``paddle_tpu/nn/functional/pooling.py``
``_pair``, ``_pad_cfg``, ``_ceil_extra``, ``_pool``, ``max_pool2d``,
``avg_pool2d`` and ``_adaptive``/``adaptive_avg_pool2d``, lines 12-87,
148-170 and 177-216).

The reference reduces windows with ``lax.reduce_window`` (no Pallas
kernel); the port calls PyTorch's pooling, on the card its CUDA kernels.
Max pooling pads with -inf, so a padded position never wins; a tie in a
window sends the gradient to its first maximum, as JAX's does. Average
pooling with ``exclusive`` (the default) divides each window by the
positions it covers inside the input (``count_include_pad=False``),
otherwise by the window's size. Padding takes the reference's forms
(an int, one a spatial axis, (low, high) pairs flattened or nested;
"SAME"/"VALID"); ``ceil_mode`` adds the reference's extra high padding
for the last window. Uneven padding goes through ``F.pad`` (-inf for
max, zeros for average with the count taken over the input).

``adaptive_avg_pool2d`` is the reference's: when every spatial size
divides by its output size, an average over uniform windows; otherwise
each output cell is the mean of ``[floor(i n / o), ceil((i + 1) n / o))``
along each axis, one axis after the other.

Cast points under the reference's op names: "max_pool2d",
"avg_pool2d", "adaptive_avg_pool2d". ``return_mask`` is not ported: it
raises, naming ROADMAP Queue A 14.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...amp import cast
from .conv import REST_ITEM, _pair, _same_pads

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _pad_cfg(padding, nd):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    return [tuple(p) for p in padding[-nd:]]


def _ceil_extra(size, k, s, lo, hi):
    """Extra high padding so the last (ceil-mode) window is covered."""
    span = size + lo + hi
    out_floor = (span - k) // s + 1
    out_ceil = -(-(span - k) // s) + 1
    if out_ceil > out_floor:
        return (out_ceil - 1) * s + k - span
    return 0


def _pool(x, ksize, stride, padding, mode, ceil_mode, exclusive,
          data_format):
    nd = 2
    ksize = _pair(ksize, nd)
    stride = _pair(stride if stride is not None else ksize, nd)
    (x,) = cast(f"{mode}_pool{nd}d", x)
    last = not data_format.startswith("NC")
    if last:
        x = x.movedim(-1, 1)
    spatial = x.shape[2:]
    pad = _pad_cfg(padding, nd)
    if pad == "VALID":
        pad = [(0, 0)] * nd
    elif pad == "SAME":
        pad = _same_pads(spatial, ksize, stride, (1,) * nd)
    elif ceil_mode:
        pad = [(lo, hi + _ceil_extra(sz, k, s, lo, hi))
               for (lo, hi), sz, k, s in zip(pad, spatial, ksize, stride)]
    flat = [v for lo_hi in reversed(pad) for v in lo_hi]
    if mode == "max":
        if any(lo != hi or 2 * lo > k for (lo, hi), k in zip(pad, ksize)):
            x = F.pad(x, flat, value=-math.inf)
            pad = [(0, 0)] * nd
        out = F.max_pool2d(x, ksize, stride, [lo for lo, _ in pad])
    else:
        # each window's sum over zero padding, divided by its count of
        # positions inside the input (exclusive; not for a string
        # padding, as in the reference) or by its size
        summed = F.avg_pool2d(F.pad(x, flat), ksize, stride,
                              divisor_override=1)
        if exclusive and not isinstance(padding, str):
            ones = torch.ones((1, 1) + tuple(spatial), dtype=x.dtype,
                              device=x.device)
            out = summed / F.avg_pool2d(F.pad(ones, flat), ksize, stride,
                                        divisor_override=1)
        else:
            out = summed / float(np.prod(ksize))
    return out.movedim(1, -1) if last else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        raise NotImplementedError(f"max_pool2d(return_mask=True) is not "
                                  f"ported yet ({REST_ITEM})")
    return _pool(x, kernel_size, stride, padding, "max", ceil_mode, True,
                 data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, "avg", ceil_mode,
                 exclusive, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Average to ``output_size`` cells (module docstring)."""
    nd = 2
    out_sp = _pair(output_size, nd)
    (x,) = cast("adaptive_avg_pool2d", x)
    last = not data_format.startswith("NC")
    axes = list(range(1, 1 + nd)) if last else list(range(2, 2 + nd))
    spatial = [x.shape[a] for a in axes]
    if all(s % o == 0 for s, o in zip(spatial, out_sp)):
        ks = tuple(s // o for s, o in zip(spatial, out_sp))
        v = x.movedim(-1, 1) if last else x
        out = F.avg_pool2d(v, ks, ks, divisor_override=1) / float(
            np.prod(ks))
        return out.movedim(1, -1) if last else out
    out = x
    for ax, o in zip(axes, out_sp):
        size = out.shape[ax]
        starts = np.floor(np.arange(o) * size / o).astype(int)
        ends = np.ceil((np.arange(o) + 1) * size / o).astype(int)
        out = torch.cat([out.narrow(ax, s0, e0 - s0).mean(ax, keepdim=True)
                         for s0, e0 in zip(starts, ends)], dim=ax)
    return out
