"""Pooling (reference: ``paddle_tpu/nn/functional/pooling.py``): the max
and average pools in 1, 2 and 3 dimensions, the adaptive ones, and
``return_mask``.

The reference reduces windows with ``lax.reduce_window`` (no Pallas
kernel); the port calls PyTorch's pooling, on the card its CUDA kernels
(a 1-D pool runs as a 2-D one over a unit axis). Max pooling pads with
-inf, so a padded position never wins; a tie in a window sends the
gradient to its first maximum, as JAX's does. Average pooling with
``exclusive`` (the default) divides each window by the positions it
covers inside the input, otherwise by the window's size. Padding takes
the reference's forms (an int, one a spatial axis, (low, high) pairs
flattened or nested; "SAME"/"VALID"); ``ceil_mode`` adds the
reference's extra high padding for the last window. Uneven padding goes
through ``F.pad`` (-inf for max, zeros for average with the count taken
over the input). As in the reference, ``divisor_override`` is taken and
not used.

**``return_mask``** (``_max_pool_with_mask``, ``pooling.py:90``) is the
reference's: the input padded with the dtype's lowest finite value (not
-inf), each window's maximum and the first position that holds it, as
an int32 index into the flattened unpadded spatial input (a padded
position clipped onto the border). The maximum's gradient is shared
among a window's ties, as ``jnp.max``'s is (the mask-less pool gives it
all to the first).

**Adaptive pools** are the reference's ``_adaptive`` (``:177``): when
every spatial size divides by its output size, a pool over uniform
windows; otherwise each output cell reduces ``[floor(i n / o), ceil((i +
1) n / o))`` along each axis, one axis after the other (a max there
shares a tie's gradient). ``return_mask`` needs divisible sizes, as in
the reference.

Cast points under the reference's op names: "max_pool{1,2,3}d",
"avg_pool{1,2,3}d", "max_pool{1,2,3}d_mask",
"adaptive_{avg,max}_pool{1,2,3}d".
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...amp import cast
from .conv import _pair, _same_pads

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

_MAX = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {2: F.avg_pool2d, 3: F.avg_pool3d}


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


def _channels_first(x, data_format):
    last = not data_format.startswith("NC")
    return (x.movedim(-1, 1) if last else x), last


def _as_2d(x, nd, *tuples):
    """A 1-D pool's input and window as a 2-D one's (a unit axis first)."""
    if nd != 1:
        return (x, *tuples)
    return (x.unsqueeze(2), *[((1,) + tuple(t)) if not isinstance(t, list)
                              else [(0, 0)] + t for t in tuples])


def _pool(x, ksize, stride, padding, nd, mode, ceil_mode, exclusive,
          data_format):
    ksize = _pair(ksize, nd)
    stride = _pair(stride if stride is not None else ksize, nd)
    (x,) = cast(f"{mode}_pool{nd}d", x)
    x, last = _channels_first(x, data_format)
    spatial = x.shape[2:]
    pad = _pad_cfg(padding, nd)
    if pad == "VALID":
        pad = [(0, 0)] * nd
    elif pad == "SAME":
        pad = _same_pads(spatial, ksize, stride, (1,) * nd)
    elif ceil_mode:
        pad = [(lo, hi + _ceil_extra(sz, k, s, lo, hi))
               for (lo, hi), sz, k, s in zip(pad, spatial, ksize, stride)]
    v, ks, st, pd = _as_2d(x, nd, ksize, stride, list(pad))
    n2 = max(nd, 2)
    flat = [p for lo_hi in reversed(pd) for p in lo_hi]
    if mode == "max":
        if any(lo != hi or 2 * lo > k for (lo, hi), k in zip(pd, ks)):
            v = F.pad(v, flat, value=-math.inf)
            pd = [(0, 0)] * n2
        out = _MAX[n2](v, ks, st, [lo for lo, _ in pd])
    else:
        # each window's sum over zero padding, divided by its count of
        # positions inside the input (exclusive; not for a string
        # padding, as in the reference) or by its size
        summed = _AVG[n2](F.pad(v, flat), ks, st, divisor_override=1)
        if exclusive and not isinstance(padding, str):
            ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                              device=v.device)
            out = summed / _AVG[n2](F.pad(ones, flat), ks, st,
                                    divisor_override=1)
        else:
            out = summed / float(np.prod(ks))
    if nd == 1:
        out = out.squeeze(2)
    return out.movedim(1, -1) if last else out


def _max_pool_with_mask(x, ksize, stride, padding, nd, ceil_mode,
                        data_format):
    """(values, int32 flattened indices): the module docstring."""
    if not data_format.startswith("NC"):
        raise NotImplementedError("return_mask requires channel-first "
                                  "layout")
    ksize = _pair(ksize, nd)
    stride = _pair(stride if stride is not None else ksize, nd)
    pad = _pad_cfg(padding, nd)
    if isinstance(pad, str):
        raise NotImplementedError("return_mask with string padding")
    spatial = x.shape[2:]
    if ceil_mode:
        pad = [(lo, hi + _ceil_extra(sz, k, s, lo, hi))
               for (lo, hi), sz, k, s in zip(pad, spatial, ksize, stride)]
    (v,) = cast(f"max_pool{nd}d_mask", x)
    n, c = v.shape[:2]
    flat = [p for lo_hi in reversed(pad) for p in lo_hi]
    w = F.pad(v, flat, value=torch.finfo(v.dtype).min)
    for d in range(nd):
        w = w.unfold(2 + d, ksize[d], stride[d])
    out_sp = w.shape[2:2 + nd]
    w = w.reshape(n, c, *out_sp, -1)
    vals = w.amax(-1)
    widx = w.argmax(-1)
    coords = []
    rem = widx
    for d in range(nd - 1, -1, -1):
        coords.insert(0, rem % ksize[d])
        rem = rem // ksize[d]
    idx = torch.zeros_like(widx)
    for d in range(nd):
        shape = [1] * widx.dim()
        shape[2 + d] = out_sp[d]
        base = (torch.arange(out_sp[d], device=v.device)
                * stride[d]).reshape(shape)
        g = (coords[d] + base - pad[d][0]).clamp(0, spatial[d] - 1)
        idx = idx * spatial[d] + g
    return vals, idx.to(torch.int32)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 1,
                                   ceil_mode, data_format)
    return _pool(x, kernel_size, stride, padding, 1, "max", ceil_mode, True,
                 data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 2,
                                   ceil_mode, data_format)
    return _pool(x, kernel_size, stride, padding, 2, "max", ceil_mode, True,
                 data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 3,
                                   ceil_mode, data_format)
    return _pool(x, kernel_size, stride, padding, 3, "max", ceil_mode, True,
                 data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", ceil_mode,
                 exclusive, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", ceil_mode,
                 exclusive, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", ceil_mode,
                 exclusive, data_format)


def _adaptive(x, output_size, nd, mode, data_format):
    """Reduce to ``output_size`` cells (module docstring)."""
    out_sp = _pair(output_size, nd)
    (x,) = cast(f"adaptive_{mode}_pool{nd}d", x)
    last = not data_format.startswith("NC")
    axes = list(range(1, 1 + nd)) if last else list(range(2, 2 + nd))
    spatial = [x.shape[a] for a in axes]
    if all(s % o == 0 for s, o in zip(spatial, out_sp)):
        ks = tuple(s // o for s, o in zip(spatial, out_sp))
        v, k2 = _as_2d(x.movedim(-1, 1) if last else x, nd, ks)
        n2 = max(nd, 2)
        if mode == "max":
            out = _MAX[n2](v, k2, k2)
        else:
            out = _AVG[n2](v, k2, k2, divisor_override=1) / float(
                np.prod(ks))
        if nd == 1:
            out = out.squeeze(2)
        return out.movedim(1, -1) if last else out
    out = x
    for ax, o in zip(axes, out_sp):
        size = out.shape[ax]
        starts = np.floor(np.arange(o) * size / o).astype(int)
        ends = np.ceil((np.arange(o) + 1) * size / o).astype(int)
        segs = [out.narrow(ax, s0, e0 - s0) for s0, e0 in zip(starts, ends)]
        out = torch.cat([s.amax(ax, keepdim=True) if mode == "max"
                         else s.mean(ax, keepdim=True) for s in segs],
                        dim=ax)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def _adaptive_max_mask(x, output_size, nd):
    out_sp = _pair(output_size, nd)
    spatial = x.shape[2:]
    if not all(s % o == 0 for s, o in zip(spatial, out_sp)):
        raise NotImplementedError("adaptive max pool return_mask requires "
                                  "divisible spatial dims")
    ks = tuple(s // o for s, o in zip(spatial, out_sp))
    return _max_pool_with_mask(x, ks, ks, 0, nd, False, "NC")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 1)
    return _adaptive(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 2)
    return _adaptive(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 3)
    return _adaptive(x, output_size, 3, "max", "NCDHW")
