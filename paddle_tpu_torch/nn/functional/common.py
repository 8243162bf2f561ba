"""Common functionals (reference: ``paddle_tpu/nn/functional/common.py``):
``linear``, the dropout family, ``embedding``, ``one_hot``,
``label_smooth``, ``pad``/``zeropad2d``, ``normalize``,
``cosine_similarity``, ``pairwise_distance``, ``interpolate``/
``upsample``, ``unfold``/``fold``, ``bilinear``, the pixel and channel
shuffles, ``affine_grid``/``grid_sample``, ``max_unpool1d/2d/3d`` and
``diag_embed``. Each is a cast point of ``amp`` under the reference's op
name.

``linear`` keeps Paddle's weight layout ``[in_features, out_features]``:
``y = x @ W + b`` ("linear", on the white list).

**Dropout** draws its keep mask from the generator of the input's device
(``framework/random.py``: Philox on the card, with no host copy, and the
CPU's Mersenne Twister; ``paddle.seed`` makes either repeat), a
Bernoulli of ``1 - p`` over the input's shape, or over the axes in
``axis`` with size 1 elsewhere (``dropout2d``/``dropout3d``: axes 0 and
the channel's, whole channels). The arithmetic is the reference's, term
for term: ``upscale_in_train`` keeps ``x / (1 - p)`` (a true division,
by a tensor on the input's device: PyTorch's CUDA division multiplies
by the reciprocal of a host scalar) and ``downscale_in_infer`` keeps
``x`` and scales by ``1 - p`` at inference ("dropout_infer"); ``p = 1``
gives zeros; at rate 0 or at inference the identity is ``clone`` (no
copy on the models' path: nothing writes to it in place). ``alpha_dropout`` keeps ``a x +
b`` and sets ``a alpha' + b`` elsewhere, ``alpha' = -1.7580993408473766``
(SELU's ``-alpha * scale``), ``a = 1 / sqrt((1 - p)(1 + p alpha'^2))``
and ``b = -a alpha' p``, in fp32 as the reference computes them.

**interpolate** reads the output size from ``size`` or
``int(in * scale_factor)``. The 2-D ``nearest`` and ``bilinear`` modes
are the reference's own sampling (its importer's ``_interp_2d``, copied
here): ``align_corners`` and ``align_mode``, floor-indexed nearest, the
fluid origin-aligned bilinear at ``align_mode=1``. Every other case is
``jax.image.resize``'s, which the reference calls: ``linear``,
``trilinear``, ``bicubic``, ``area`` (which the reference maps to
linear) and ``nearest`` outside 2-D, with half-pixel centres, the Keys
cubic kernel (a = -0.5), a kernel widened by the scale when it shrinks
(antialiasing) and ``align_corners`` ignored (ROADMAP Queue C). Those
are per-axis resampling matrices built on the host once per shape and
applied as products (``torch.nn.functional.interpolate`` computes none
of that).

``pad`` takes the reference's forms: ``2 * ndim`` values pad every axis
in order; fewer pad the trailing spatial axes from the last one back
(``data_format`` "NC..." or channels-last). ``reflect``, ``replicate``
and ``circular`` gather by numpy's ``pad`` indices (what ``jnp.pad``
computes), so any rank and width works.

``embedding``'s ``padding_idx`` and ``sparse`` are not ported
(ROADMAP Queue A, "Transformer family and nn options").
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...amp import cast
from ...framework import random as rng
from ...framework.autograd import link
from ...tensor import clone

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "zeropad2d",
           "normalize", "cosine_similarity", "interpolate", "upsample",
           "unfold", "fold", "bilinear", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "affine_grid", "grid_sample", "max_unpool1d",
           "max_unpool2d", "max_unpool3d", "pairwise_distance",
           "diag_embed", "OPTIONS_ITEM"]

OPTIONS_ITEM = "ROADMAP Queue A, 'Transformer family and nn options'"


def _ints(v):
    """A list of ints from a list, a tuple or a tensor."""
    if isinstance(v, torch.Tensor):
        return [int(s) for s in v.tolist()]
    return [int(s) for s in v]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` as ``[in, out]``."""
    if bias is None:
        x, weight = cast("linear", x, weight)
        return torch.matmul(x, weight)
    x, weight, bias = cast("linear", x, weight, bias)
    return torch.matmul(x, weight) + bias


# ------------------------------------------------------------------ dropout
def keep_mask(v: torch.Tensor, p: float, shape) -> torch.Tensor:
    """A Bernoulli(1 - p) mask of ``shape`` from the stream of ``v``'s
    device."""
    u = torch.rand(shape, generator=rng.generator_for(v.device),
                   device=v.device)
    return u < (1.0 - p)


def _true_div(v: torch.Tensor, d: float) -> torch.Tensor:
    """``v / d`` rounded once, as XLA divides by a scalar: the divisor a
    tensor on ``v``'s device (PyTorch's CUDA division multiplies by the
    reciprocal of a host scalar)."""
    return v / torch.full((), d, dtype=v.dtype, device=v.device)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and training is False and p > 0:
            (x,) = cast("dropout_infer", x)
            return x * (1.0 - p)
        return clone(x)
    (x,) = cast("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = keep_mask(x, p, shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    kept = _true_div(x, 1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return clone(x)
    (x,) = cast("alpha_dropout", x)
    alpha_p = -SELU_ALPHA * SELU_SCALE
    a = (1.0 / np.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))).astype(
        np.float32)
    b = -a * alpha_p * p                      # float32, as numpy rounds it
    keep = keep_mask(x, p, x.shape)
    filled = torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                             device=x.device))
    return float(a) * filled + float(b)


# ---------------------------------------------------------------- embedding
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows ``x`` of ``weight``, in the dtype amp gives the table. The
    rows are gathered from the table as it is and then cast, the same
    values as rows of the cast table, so the backward sums each row's
    gradients in the table's dtype (fp32 for amp's masters) on every
    device, where a gather from a bf16 copy would sum them in bf16 (on
    the CPU, rounding after each of the 4096 additions a BERT token type
    takes at 16 x 512). Through PyTorch's embedding, whose backward sums
    by sorting the ids: an indexing backward (``weight[x]``) adds with
    atomics, which serialise on two rows at BERT's two token types (5.1
    ms a step at 16 x 512 on an NVIDIA H100 80GB HBM3 at 700 W,
    ``chip_smoke.py`` phase 25's profile)."""
    if padding_idx is not None or sparse:
        raise NotImplementedError(f"embedding padding_idx/sparse is not "
                                  f"ported yet ({OPTIONS_ITEM})")
    ids, cast_weight = cast("embedding", x, weight)
    rows = F.embedding(ids, weight)
    return rows if cast_weight.dtype == weight.dtype else rows.to(
        cast_weight.dtype)


def one_hot(x, num_classes, name=None):
    """fp32 rows, all zeros for an id outside ``[0, num_classes)`` (as
    ``jax.nn.one_hot``)."""
    (x,) = cast("one_hot", x)
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        lbl, prior = cast("label_smooth", label, prior_dist)
        return (1 - epsilon) * lbl + epsilon * prior
    (lbl,) = cast("label_smooth", label)
    return (1 - epsilon) * lbl + epsilon / lbl.shape[-1]


# ---------------------------------------------------------------- padding
_NP_MODE = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


def _pad_cfg(nd, pad, data_format):
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    cfg = [(0, 0)] * nd
    npairs = len(pad) // 2
    if data_format.startswith("NC"):
        dims = list(range(nd - 1, nd - 1 - npairs, -1))
    else:
        dims = list(range(nd - 2, nd - 2 - npairs, -1))
    for i, d in enumerate(dims):
        cfg[d] = (pad[2 * i], pad[2 * i + 1])
    return cfg


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    pad = _ints(pad)
    (x,) = cast("pad", x)
    cfg = _pad_cfg(x.dim(), pad, data_format)
    if mode == "constant":
        flat = [v for lo_hi in reversed(cfg) for v in lo_hi]
        return F.pad(x, flat, value=value)
    np_mode = _NP_MODE[mode]
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=np_mode)
            x = x.index_select(d, torch.as_tensor(idx, device=x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# ---------------------------------------------------------------- distances
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    (x,) = cast("normalize", x)
    nrm = (x.abs() ** p).sum(axis, keepdim=True) ** (1.0 / p)
    return x / torch.maximum(nrm, torch.full((), epsilon, dtype=x.dtype,
                                             device=x.device))


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    a, b = cast("cosine_similarity", x1, x2)
    num = (a * b).sum(axis)
    d1 = torch.sqrt((a * a).sum(axis))
    d2 = torch.sqrt((b * b).sum(axis))
    return num / torch.maximum(d1 * d2, torch.full(
        (), eps, dtype=num.dtype, device=num.device))


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    a, b = cast("pairwise_distance", x, y)
    d = (a - b).abs() + epsilon
    return (d ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


# ------------------------------------------------------------ interpolation
def _interp_axis(in_size, out_size, align_corners, align_mode):
    """The reference's bilinear sample positions along one axis (its
    importer's ``_interp_axis``): (lo, hi, frac)."""
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * ((in_size - 1) / max(out_size - 1, 1))
    elif align_mode == 1:
        src = dst * (in_size / out_size)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def interp_2d(x, oh, ow, *, bilinear, align_corners, align_mode):
    """The reference's NCHW resize by gathers (its importer's
    ``_interp_2d``), every mode of the reference's sampling."""
    ih, iw = x.shape[2], x.shape[3]
    dev = x.device

    def take(v, idx, axis):
        return v.index_select(axis, torch.as_tensor(idx, dtype=torch.long,
                                                    device=dev))

    if not bilinear:
        if align_corners:   # rounds half up, as the reference's kernel
            idx_h = (np.arange(oh) * (ih - 1) / max(oh - 1, 1)
                     + 0.5).astype(np.int64)
            idx_w = (np.arange(ow) * (iw - 1) / max(ow - 1, 1)
                     + 0.5).astype(np.int64)
        else:
            idx_h = np.minimum(np.arange(oh) * ih // oh, ih - 1)
            idx_w = np.minimum(np.arange(ow) * iw // ow, iw - 1)
        return take(take(x, idx_h, 2), idx_w, 3)
    lo_h, hi_h, wh = _interp_axis(ih, oh, align_corners, align_mode)
    lo_w, hi_w, ww = _interp_axis(iw, ow, align_corners, align_mode)
    wh = torch.as_tensor(wh, device=dev)[None, None, :, None]
    ww = torch.as_tensor(ww, device=dev)[None, None, None, :]
    row = take(x, lo_h, 2) * (1.0 - wh) + take(x, hi_h, 2) * wh
    out = take(row, lo_w, 3) * (1.0 - ww) + take(row, hi_w, 3) * ww
    return out.to(x.dtype)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, cubic: bool) -> np.ndarray:
    """``jax.image.resize``'s ``[in, out]`` weights along one axis
    (``compute_weight_mat``, scale ``out / in``, antialiased), in fp32
    as it computes them; built once per shape (never written)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]
               ) / kernel_scale
    w = (_keys_cubic(x) if cubic else _triangle(x)).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize(v, axes, out_sp, method):
    """``jax.image.resize(v, ..., method)`` over ``axes``."""
    for ax, o in zip(axes, out_sp):
        n = v.shape[ax]
        if n == o:
            continue
        if method == "nearest":
            f32 = np.float32
            idx = np.floor((np.arange(o, dtype=f32) + f32(0.5)) * f32(n)
                           / f32(o)).astype(np.int64)
            v = v.index_select(ax, torch.as_tensor(idx, device=v.device))
            continue
        w = torch.as_tensor(resize_matrix(n, o, method == "cubic"),
                            dtype=v.dtype, device=v.device)
        v = torch.tensordot(v, w, dims=([ax], [0])).movedim(-1, ax)
    return v


_RESIZE_METHOD = {"nearest": "nearest", "bilinear": "linear",
                  "trilinear": "linear", "bicubic": "cubic",
                  "linear": "linear", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    if isinstance(size, torch.Tensor):
        size = _ints(size)
    (x,) = cast("interpolate", x)
    first = data_format == "NCHW"
    spatial = list(x.shape[2:]) if first else list(x.shape[1:-1])
    if size is not None:
        out_sp = _ints(size if isinstance(size, (list, tuple)) else [size])
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spatial))
        out_sp = [int(s * f) for s, f in zip(spatial, sf)]
    if mode in ("nearest", "bilinear") and len(out_sp) == 2:
        v = x if first else x.movedim(-1, 1)
        out = interp_2d(v, out_sp[0], out_sp[1], bilinear=mode == "bilinear",
                        align_corners=bool(align_corners),
                        align_mode=int(align_mode))
        return out if first else out.movedim(1, -1)
    axes = (list(range(2, x.dim())) if first
            else list(range(1, x.dim() - 1)))
    return _resize(x, axes, out_sp, _RESIZE_METHOD[mode])


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# --------------------------------------------------------------- im2col
def _two(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def _four(pd):
    pd = _two(pd)
    return [pd[0], pd[1], pd[0], pd[1]] if len(pd) == 2 else pd


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[n, c * kh * kw, oh * ow]``, channel-major."""
    ks, st, dl, pd = (_two(kernel_sizes), _two(strides), _two(dilations),
                      _four(paddings))
    (x,) = cast("unfold", x)
    n, c = x.shape[:2]
    v = F.pad(x, [pd[1], pd[3], pd[0], pd[2]])
    oh = (v.shape[2] - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (v.shape[3] - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    patches = [v[:, :, i * dl[0]: i * dl[0] + oh * st[0]: st[0],
                 j * dl[1]: j * dl[1] + ow * st[1]: st[1]]
               for i in range(ks[0]) for j in range(ks[1])]
    return torch.stack(patches, 2).reshape(n, c * ks[0] * ks[1], oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: the sum of ``unfold``'s patches back into ``[n, c, h, w]``."""
    os_, ks, st, dl, pd = (_two(output_sizes), _two(kernel_sizes),
                           _two(strides), _two(dilations), _four(paddings))
    (x,) = cast("fold", x)
    n, ckk, _ = x.shape
    c = ckk // (ks[0] * ks[1])
    ph, pw = os_[0] + pd[0] + pd[2], os_[1] + pd[1] + pd[3]
    oh = (ph - (dl[0] * (ks[0] - 1) + 1)) // st[0] + 1
    ow = (pw - (dl[1] * (ks[1] - 1) + 1)) // st[1] + 1
    v = x.reshape(n, c, ks[0], ks[1], oh, ow)
    out = x.new_zeros((n, c, ph, pw))
    for i in range(ks[0]):
        for j in range(ks[1]):
            di, dj = i * dl[0], j * dl[1]
            out[:, :, di: di + oh * st[0]: st[0],
                dj: dj + ow * st[1]: st[1]] += v[:, :, i, j]
    return out[:, :, pd[0]: pd[0] + os_[0], pd[1]: pd[1] + os_[1]]


def bilinear(x1, x2, weight, bias=None, name=None):
    args = cast("bilinear", x1, x2, weight,
                *(() if bias is None else (bias,)))
    out = torch.einsum("bi,oij,bj->bo", args[0], args[2], args[1])
    return out + args[3] if bias is not None else out


# ------------------------------------------------------------- shuffles
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    (v,) = cast("pixel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = v.shape
        v = v.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = v.shape
    v = v.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = int(downscale_factor)
    (v,) = cast("pixel_unshuffle", x)
    if data_format == "NCHW":
        n, c, h, w = v.shape
        v = v.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = v.shape
    v = v.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    g = int(groups)
    (v,) = cast("channel_shuffle", x)
    if data_format == "NCHW":
        n, c, h, w = v.shape
        return v.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
            n, c, h, w)
    n, h, w, c = v.shape
    return v.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


# ------------------------------------------------------------- sampling
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``[n, 2, 3]`` affine parameters -> the ``[n, H, W, 2]`` grid."""
    (th,) = cast("affine_grid", theta)
    _, _, h, w = _ints(out_shape)
    dev, dt = th.device, th.dtype
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dt = torch.promote_types(torch.float32, dt)
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(dt)
    return torch.einsum("hwk,nck->nhwc", base, th.to(dt))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` (NCHW) at ``grid`` ``[n, H, W, 2]`` (x, y in [-1, 1]):
    the reference's gathers, zeros outside under ``padding_mode="zeros"``,
    the border value otherwise."""
    v, g = cast("grid_sample", x, grid)
    n, c, h, w = v.shape
    gx, gy = g[..., 0], g[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    rows = torch.arange(n, device=v.device)[:, None, None]
    zero = torch.zeros((), dtype=v.dtype, device=v.device)

    def gather(yy, xx):
        ob = (yy < 0) | (yy > h - 1) | (xx < 0) | (xx > w - 1)
        yc = yy.clamp(0, h - 1).to(torch.long)
        xc = xx.clamp(0, w - 1).to(torch.long)
        out = v.permute(0, 2, 3, 1)[rows, yc, xc]          # [n, H, W, c]
        if padding_mode == "zeros":
            out = torch.where(ob[..., None], zero, out)
        return out

    if mode == "nearest":     # the grid's gradient is zero, not absent
        res = link(gather(torch.round(fy), torch.round(fx)), g)
    else:
        y0, x0 = torch.floor(fy), torch.floor(fx)
        wy, wx = fy - y0, fx - x0
        res = (gather(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
               + gather(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
               + gather(y0 + 1, x0) * (wy * (1 - wx))[..., None]
               + gather(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    return res.permute(0, 3, 1, 2)


# ------------------------------------------------------------- unpooling
def _unpool(x, indices, out_sp, op_name):
    """Scatter each pooled value to its flattened spatial index."""
    v, idx = cast(op_name, x, indices)
    n, c = v.shape[:2]
    flat = v.new_zeros((n, c, int(np.prod(out_sp))))
    flat = flat.scatter(2, idx.reshape(n, c, -1).to(torch.long),
                        v.reshape(n, c, -1))
    return flat.reshape(n, c, *out_sp)


def _unpool_size(sizes, ks, st, pd, output_size):
    """The reference's ``(L - 1) * stride + kernel - 2 * padding``, or the
    trailing dims of ``output_size``."""
    if output_size is not None:
        return [int(s) for s in list(output_size)[-len(sizes):]]
    return [(s - 1) * t + k - 2 * int(p)
            for s, k, t, p in zip(sizes, ks, st, pd)]


def _tuple(v, nd):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * nd


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    ks = kernel_size[0] if isinstance(kernel_size, (list, tuple)) \
        else kernel_size
    st = stride or ks
    st = st[0] if isinstance(st, (list, tuple)) else st
    out_sp = _unpool_size(x.shape[2:], [int(ks)], [int(st)], [padding],
                          output_size)
    return _unpool(x, indices, out_sp, "max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    ks = _tuple(kernel_size, 2)
    st = _tuple(stride or ks, 2)
    out_sp = _unpool_size(x.shape[2:], ks, st, _tuple(padding, 2),
                          output_size)
    return _unpool(x, indices, out_sp, "max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    ks = _tuple(kernel_size, 3)
    st = _tuple(stride or ks, 3)
    out_sp = _unpool_size(x.shape[2:], ks, st, _tuple(padding, 3),
                          output_size)
    return _unpool(x, indices, out_sp, "max_unpool3d")


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last axis as a diagonal of new square matrices, their two axes
    placed at ``dim1`` (rows) and ``dim2`` (columns) of the output."""
    (v,) = cast("diag_embed", input)
    off = int(offset)
    n = v.shape[-1] + abs(off)
    r = torch.arange(v.shape[-1], device=v.device)
    out = v.new_zeros(v.shape[:-1] + (n, n))
    out[..., r + max(-off, 0), r + max(off, 0)] = v
    nd = out.dim()
    src = {dim1 % nd: nd - 2, dim2 % nd: nd - 1}
    rest = iter(range(nd - 2))
    return out.permute([src[i] if i in src else next(rest)
                        for i in range(nd)])
