"""Elementwise, reduction and product ops (reference:
``paddle_tpu/tensor/math.py``), each under the reference's op name.

A reference op that computes by a formula of its own (``frac``,
``logit``, ``lerp``, ``cdist``, ``frexp``, ``renorm``, ...) is computed
by the same formula here, not by the PyTorch op of that name, whose
rounding or conventions differ (``torch.lerp`` switches formulas at
weight 0.5, ``torch.median`` takes the lower of two middles). A Python
scalar in a formula is a weak operand, as in JAX: it takes a floating
tensor's dtype (``weak``) and turns an integer tensor into float32.

Matmuls on the card run under the port's fp32 GEMM settings
(``framework/precision.py`` ``matmul_precision("float32")``: TF32 off,
bf16 products summed in fp32), as the models' fp32 GEMMs do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.precision import matmul_precision
from ._helpers import (INDEX, Tensor, as_tensor, binary, normalize_axis, op,
                       scalar_of, unary, val)

def weak(s, v: torch.Tensor):
    """A Python scalar ``s`` as JAX's weakly typed operand beside ``v``:
    rounded to ``v``'s dtype when ``v`` is floating, else left for
    PyTorch to promote (an int tensor with a float scalar is float32)."""
    if isinstance(s, (int, float)) and (v.is_floating_point()
                                        or v.is_complex()):
        return scalar_of(s, v.dtype)
    return s


def _float(v: torch.Tensor) -> torch.Tensor:
    """``v`` as JAX's inexact ops take it: integers and bools as float32."""
    return v if v.is_floating_point() or v.is_complex() else v.float()


def _dims(axis, ndim):
    """A reduction's ``dim`` for ``axis`` (None: every axis)."""
    ax = normalize_axis(axis, ndim)
    if ax is None:
        return tuple(range(ndim))
    return ax


def _matmul(a, b):
    if a.is_cuda:
        with matmul_precision("float32"):
            return torch.matmul(a, b)
    return torch.matmul(a, b)


# ----------------------------------------------------------------- elementwise
def add(x, y, name=None):
    return binary(torch.add, x, y, "add")


def subtract(x, y, name=None):
    return binary(torch.sub, x, y, "subtract")


def multiply(x, y, name=None):
    return binary(torch.mul, x, y, "multiply")


def divide(x, y, name=None):
    return binary(torch.true_divide, x, y, "divide")


def _int_divisor(a, b):
    """``b`` as a tensor of ``a``'s integer dtype, and where it is 0."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return b, b == 0


def _floor_divide(a, b):
    """JAX's integer floor division: ``x // 0`` is XLA's quotient -1,
    less one where ``x`` is not 0 (``jnp.floor_divide``'s sign rule)."""
    if a.is_floating_point() or a.is_complex():
        return torch.floor_divide(a, b)
    b, zero = _int_divisor(a, b)
    if not bool(zero.any()):
        return torch.floor_divide(a, b)
    q = torch.floor_divide(a, torch.where(zero, torch.ones_like(b), b))
    by_zero = torch.where(a != 0, -2, -1).to(a.dtype)
    return torch.where(zero, by_zero, q)


def _remainder(a, b):
    """JAX's integer remainder: a divisor of 0 counts as 1
    (``jnp.remainder``), so ``x % 0`` is 0."""
    if a.is_floating_point() or a.is_complex():
        return torch.remainder(a, b)
    b, zero = _int_divisor(a, b)
    return torch.remainder(a, torch.where(zero, torch.ones_like(b), b))


def floor_divide(x, y, name=None):
    return binary(_floor_divide, x, y, "floor_divide")


def remainder(x, y, name=None):
    return binary(_remainder, x, y, "remainder")


mod = remainder
floor_mod = remainder


def _pow(a, b):
    """``torch.pow``; an integer base to a negative integer power is the
    reference's: ``jnp.power``'s binary exponentiation reads the
    exponent's low 6 bits, so ``x ** e`` is ``x ** (e & 63)``, wrapping
    (``2 ** -1`` is 0, ``(-1) ** -1`` is -1, ``3 ** -1`` is ``3 ** 63``
    in int32), where PyTorch refuses a Python exponent."""
    if a.is_floating_point() or a.is_complex() or (
            isinstance(b, torch.Tensor) and (b.is_floating_point()
                                             or b.is_complex())) \
            or isinstance(b, float):
        return torch.pow(a, b)
    e = torch.as_tensor(b, device=a.device)
    if not bool((e < 0).any()):
        return torch.pow(a, b)
    return torch.pow(a, torch.where(e < 0, torch.bitwise_and(e, 63), e))


def pow(x, y, name=None):
    return binary(_pow, x, y, "pow")


def maximum(x, y, name=None):
    return binary(torch.maximum, x, y, "maximum")


def minimum(x, y, name=None):
    return binary(torch.minimum, x, y, "minimum")


def fmax(x, y, name=None):
    return binary(torch.fmax, x, y, "fmax")


def fmin(x, y, name=None):
    return binary(torch.fmin, x, y, "fmin")


class _Atan2(torch.autograd.Function):
    """``atan2`` with the reference's gradients, ``y / (x^2 + y^2)`` and
    ``-x / (x^2 + y^2)``: NaN at (0, 0), where PyTorch's is 0."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.atan2(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        den = a * a + b * b
        ga = (g * (b / den)).sum_to_size(a.shape)
        gb = (g * (-a / den)).sum_to_size(b.shape)
        return ga, gb


def _atan2(a, b):
    if a.is_floating_point() and torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad):
        return _Atan2.apply(a, b)
    return torch.atan2(a, b)


def atan2(x, y, name=None):
    return binary(_atan2, x, y, "atan2")


def heaviside(x, y, name=None):
    return binary(torch.heaviside, x, y, "heaviside")


def inner(x, y, name=None):
    return binary(torch.inner, x, y, "inner")


def outer(x, y, name=None):
    return binary(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                  x, y, "outer")


def logaddexp(x, y, name=None):
    return binary(lambda a, b: torch.logaddexp(_float(a), _float(b)), x, y,
                  "logaddexp")


def nextafter(x, y, name=None):
    return binary(torch.nextafter, x, y, "nextafter")


def copysign(x, y, name=None):
    return binary(lambda a, b: torch.copysign(_float(a), _float(b)), x, y,
                  "copysign")


# ------------------------------------------------------------------- unary
class _Abs(torch.autograd.Function):
    """``torch.abs`` with the reference's gradient: ``g`` where ``x >=
    0`` (so 1 at 0 and -0.0), ``-g`` elsewhere. PyTorch's is 0 at 0."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return torch.abs(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return torch.where(v >= 0, g, -g)


def abs_value(v: torch.Tensor) -> torch.Tensor:
    """``|v|`` of a payload, with ``_Abs``'s gradient for a real floating
    ``v`` that records one (the ops built on the reference's
    ``jnp.abs``: ``abs``, ``norm``, ``dist``, ``cdist``, ``renorm``)."""
    if v.is_floating_point() and v.requires_grad and torch.is_grad_enabled():
        return _Abs.apply(v)
    return torch.abs(v)


def abs(x, name=None):
    return unary(abs_value, x, "abs")


def neg(x, name=None):
    return unary(torch.neg, x, "neg")


def exp(x, name=None):
    return unary(torch.exp, x, "exp")


def expm1(x, name=None):
    return unary(torch.expm1, x, "expm1")


def log(x, name=None):
    return unary(torch.log, x, "log")


def log2(x, name=None):
    return unary(torch.log2, x, "log2")


def log10(x, name=None):
    return unary(torch.log10, x, "log10")


def log1p(x, name=None):
    return unary(torch.log1p, x, "log1p")


def sqrt(x, name=None):
    return unary(torch.sqrt, x, "sqrt")


def rsqrt(x, name=None):
    return unary(torch.rsqrt, x, "rsqrt")


def square(x, name=None):
    return unary(torch.square, x, "square")


def _sign(v):
    """``jnp.sign``: -0.0 keeps its sign and NaN stays NaN (PyTorch's
    ``sign`` gives 0.0 for both); the gradient is 0 everywhere."""
    if not v.is_floating_point():
        return torch.sign(v)
    out = torch.copysign(torch.sign(v), v)
    return torch.where(torch.isnan(v), v.detach(), out)


def sign(x, name=None):
    return unary(_sign, x, "sign")


def sin(x, name=None):
    return unary(torch.sin, x, "sin")


def cos(x, name=None):
    return unary(torch.cos, x, "cos")


def tan(x, name=None):
    return unary(torch.tan, x, "tan")


def asin(x, name=None):
    return unary(torch.asin, x, "asin")


def acos(x, name=None):
    return unary(torch.acos, x, "acos")


def atan(x, name=None):
    return unary(torch.atan, x, "atan")


def sinh(x, name=None):
    return unary(torch.sinh, x, "sinh")


def cosh(x, name=None):
    return unary(torch.cosh, x, "cosh")


def tanh(x, name=None):
    return unary(torch.tanh, x, "tanh")


def asinh(x, name=None):
    return unary(torch.asinh, x, "asinh")


def acosh(x, name=None):
    return unary(torch.acosh, x, "acosh")


def atanh(x, name=None):
    return unary(torch.atanh, x, "atanh")


def ceil(x, name=None):
    return unary(torch.ceil, x, "ceil")


def floor(x, name=None):
    return unary(torch.floor, x, "floor")


def round(x, name=None):
    return unary(torch.round, x, "round")


def trunc(x, name=None):
    return unary(torch.trunc, x, "trunc")


def frac(x, name=None):
    return unary(lambda v: v - torch.trunc(v), x, "frac")


def reciprocal(x, name=None):
    return unary(torch.reciprocal, x, "reciprocal")


def erf(x, name=None):
    return unary(torch.erf, x, "erf")


def erfinv(x, name=None):
    return unary(torch.erfinv, x, "erfinv")


def lgamma(x, name=None):
    return unary(torch.lgamma, x, "lgamma")


def digamma(x, name=None):
    return unary(torch.digamma, x, "digamma")


def logit(x, eps=None, name=None):
    def fn(v):
        v = _float(v)
        if eps is not None:
            v = torch.clamp(v, weak(eps, v), weak(1.0 - eps, v))
        return torch.log(v / (1.0 - v))

    return unary(fn, x, "logit")


def sigmoid(x, name=None):
    return unary(torch.sigmoid, x, "sigmoid")


def isfinite(x, name=None):
    return unary(torch.isfinite, x, "isfinite")


def isnan(x, name=None):
    return unary(torch.isnan, x, "isnan")


def isinf(x, name=None):
    return unary(torch.isinf, x, "isinf")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return unary(lambda v: torch.nan_to_num(v, nan=nan, posinf=posinf,
                                            neginf=neginf), x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s, b = val(scale), val(bias)

    def fn(v):
        sv, bv = weak(s, v), weak(b, v)
        return v * sv + bv if bias_after_scale else (v + bv) * sv

    return unary(fn, x, "scale")


def increment(x, value=1.0, name=None):
    new = unary(lambda v: v + weak(value, v), x, "increment")
    x._replace_from(new)
    return x


def clip(x, min=None, max=None, name=None):
    lo = val(min)
    hi = val(max)

    def bound(b, v):
        return torch.as_tensor(weak(b, v) if not isinstance(b, torch.Tensor)
                               else b, dtype=v.dtype, device=v.device)

    def fn(v):
        """``maximum`` then ``minimum``, as ``jnp.clip``: a value at a
        bound takes half the gradient there (the tie's split)."""
        if not v.is_floating_point() and (isinstance(lo, float)
                                          or isinstance(hi, float)):
            v = v.float()
        if lo is not None:
            v = torch.maximum(v, bound(lo, v))
        if hi is not None:
            v = torch.minimum(v, bound(hi, v))
        return v

    return unary(fn, x, "clip")


def lerp(x, y, weight, name=None):
    w = weight if isinstance(weight, (Tensor, torch.Tensor)) else (
        as_tensor(weight, val(x)))
    return op(lambda a, b, t: a + t * (b - a), x, y, w, op_name="lerp")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    def fn(v):
        v = _float(v)
        return weak(scale_b, v) * torch.tanh(weak(scale_a, v) * v)

    return unary(fn, x, "stanh")


def rad2deg(x, name=None):
    return unary(lambda v: _float(v) * weak(180.0 / np.pi, _float(v)), x)


def deg2rad(x, name=None):
    return unary(lambda v: _float(v) * weak(np.pi / 180.0, _float(v)), x)


def angle(x, name=None):
    return unary(lambda v: torch.angle(_float(v)), x)


def conj(x, name=None):
    return unary(torch.conj_physical, x)


def gcd(x, y, name=None):
    return binary(torch.gcd, x, y)


def lcm(x, y, name=None):
    return binary(torch.lcm, x, y)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    pre, app = val(prepend), val(append)
    return unary(lambda v: torch.diff(v, n=n, dim=axis, prepend=pre,
                                      append=app), x)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return unary(lambda v: torch.diagonal(v, offset, axis1, axis2).sum(-1),
                 x)


# ---------------------------------------------------------------- reductions
def _reduce(fn, x, axis, keepdim, name, dtype=None):
    def body(v):
        out = fn(v, _dims(axis, v.ndim), keepdim)
        return out if dtype is None else out.to(dtype)

    return op(body, x, op_name=name)


def _sum(v, dims, keepdim):
    return torch.sum(v, dims, keepdim=keepdim)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    from ._helpers import convert_dtype

    dt = convert_dtype(dtype)
    if dt is None and val(x).dtype == torch.bool:
        dt = torch.int32
    return _reduce(_sum, x, axis, keepdim, "sum", dtype=dt)


def mean(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda v, d, k: torch.mean(_float(v), d, keepdim=k), x,
                   axis, keepdim, "mean")


def _prod(v, dims, keepdim):
    if isinstance(dims, int):
        dims = (dims,)
    if not dims:
        return v.clone()
    rest = [d for d in range(v.ndim) if d not in dims]
    out = v.permute(*rest, *dims).reshape(
        *[v.shape[d] for d in rest], -1).prod(-1)
    if keepdim:
        for d in sorted(dims):
            out = out.unsqueeze(d)
    return out


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    from ._helpers import convert_dtype

    return _reduce(_prod, x, axis, keepdim, "prod",
                   dtype=convert_dtype(dtype))


def _amax(v, d, k):
    return torch.amax(v, d, keepdim=k)


def _amin(v, d, k):
    return torch.amin(v, d, keepdim=k)


def max(x, axis=None, keepdim=False, name=None):
    return _reduce(_amax, x, axis, keepdim, "max")


def min(x, axis=None, keepdim=False, name=None):
    return _reduce(_amin, x, axis, keepdim, "min")


def amax(x, axis=None, keepdim=False, name=None):
    return _reduce(_amax, x, axis, keepdim, "amax")


def amin(x, axis=None, keepdim=False, name=None):
    return _reduce(_amin, x, axis, keepdim, "amin")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return _reduce(lambda v, d, k: torch.nansum(v, d, keepdim=k), x, axis,
                   keepdim, "nansum")


def nanmean(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda v, d, k: torch.nanmean(_float(v), d, keepdim=k),
                   x, axis, keepdim, "nanmean")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    """``sqrt(var)``, as the reference composes it: the gradient of a
    constant input is NaN (``sqrt``'s at 0 times ``var``'s 0), where
    ``torch.std``'s is 0."""
    return _reduce(lambda v, d, k: torch.sqrt(torch.var(
        _float(v), d, correction=int(unbiased), keepdim=k)),
                   x, axis, keepdim, "std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce(lambda v, d, k: torch.var(_float(v), d,
                                             correction=int(unbiased),
                                             keepdim=k),
                   x, axis, keepdim, "var")


def _quantile(v, q, axis, keepdim, fn=torch.quantile,
              interpolation="linear"):
    """JAX's ``quantile`` over ``axis`` (None: all; a tuple: those axes
    merged) by ``fn`` (``torch.quantile`` or ``nanquantile``)."""
    v = _float(v)
    ax = normalize_axis(axis, v.ndim)
    if ax is None or isinstance(ax, tuple):
        dims = tuple(range(v.ndim)) if ax is None else ax
        rest = [d for d in range(v.ndim) if d not in dims]
        flat = v.permute(*rest, *dims).reshape(*[v.shape[d] for d in rest],
                                               -1)
        out = fn(flat, q, dim=-1, interpolation=interpolation)
        if keepdim:
            lead = out.ndim - len(rest)
            for d in sorted(dims):
                out = out.unsqueeze(lead + d)
        return out
    return fn(v, q, dim=ax, keepdim=keepdim, interpolation=interpolation)


def median(x, axis=None, keepdim=False, name=None):
    return op(lambda v: _quantile(v, 0.5, axis, keepdim,
                                  interpolation="midpoint"),
              x, op_name="median")


def quantile(x, q, axis=None, keepdim=False, name=None):
    def fn(v):
        qq = (torch.as_tensor(np.asarray(q, np.float32), device=v.device)
              if isinstance(q, (list, tuple, np.ndarray)) else float(val(q)))
        return _quantile(v, qq, axis, keepdim)

    return op(fn, x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda v, d, k: torch.logsumexp(_float(v), d, keepdim=k),
                   x, axis, keepdim, "logsumexp")


def all(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda v, d, k: torch.all(v.bool(), d, keepdim=k), x, axis,
                   keepdim, "all")


def any(x, axis=None, keepdim=False, name=None):
    return _reduce(lambda v, d, k: torch.any(v.bool(), d, keepdim=k), x, axis,
                   keepdim, "any")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def fn(v):
        dims = _dims(axis, v.ndim)
        return torch.sum(v != 0, dims, keepdim=keepdim).to(INDEX)

    return op(fn, x)


# ------------------------------------------------------------------- cumulative
def _scan(fn, v, axis):
    """A cumulative op in JAX's dtype: an integer input keeps its dtype
    (PyTorch's widens to int64), a bool one counts in int32."""
    out = fn(v.reshape(-1), 0) if axis is None else fn(v, int(axis))
    if v.dtype != torch.bool and not v.is_floating_point() and (
            not v.is_complex()):
        out = out.to(v.dtype)
    return out


def cumsum(x, axis=None, dtype=None, name=None):
    return op(lambda v: _scan(torch.cumsum, v, axis), x, op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    return op(lambda v: _scan(torch.cumprod, v, dim), x, op_name="cumprod")


def _cum(fn, v, axis):
    if axis is None:
        return fn(v.reshape(-1), 0).values
    return fn(v, int(axis)).values


def cummax(x, axis=None, dtype="int64", name=None):
    return op(lambda v: _cum(torch.cummax, v, axis), x, op_name="cummax")


def cummin(x, axis=None, dtype="int64", name=None):
    return op(lambda v: _cum(torch.cummin, v, axis), x, op_name="cummin")


# ------------------------------------------------------------------- matmul-ish
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.ndim > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim > 1:
            b = b.transpose(-1, -2)
        return _matmul(a, b)

    return op(fn, x, y, op_name="matmul")


mm = matmul


def dot(x, y, name=None):
    def fn(a, b):
        if a.ndim == 2:
            return torch.sum(a * b, -1)
        return torch.dot(a, b)

    return op(fn, x, y, op_name="dot")


def bmm(x, y, name=None):
    return op(_matmul, x, y, op_name="bmm")


def mv(x, vec, name=None):
    return op(_matmul, x, vec, op_name="mv")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    def fn(i, a, b):
        return weak(beta, i) * i + weak(alpha, i) * _matmul(a, b)

    return op(fn, input, x, y, op_name="addmm")


def kron(x, y, name=None):
    return op(torch.kron, x, y, op_name="kron")


def multiply_(x, y):
    x._replace_from(multiply(x, y))
    return x


def add_(x, y):
    x._replace_from(add(x, y))
    return x


def subtract_(x, y):
    x._replace_from(subtract(x, y))
    return x


def divide_(x, y):
    x._replace_from(divide(x, y))
    return x


def scale_(x, scale_v=1.0, bias=0.0, bias_after_scale=True, act=None,
           name=None):
    x._replace_from(scale(x, scale_v, bias, bias_after_scale))
    return x


def clip_(x, min=None, max=None, name=None):
    x._replace_from(clip(x, min, max))
    return x


# ---------------------------------------------------------------------------
# the reference's tail: cdist/take/logcumsumexp/renorm/frexp/trapezoid/
# vander/nanmedian/polygamma/i0
# ---------------------------------------------------------------------------
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-norm distance; p = 2 by the matmul expansion, as the
    reference computes it."""
    def fn(a, b):
        if p == 2.0:
            a2 = torch.sum(a * a, -1, keepdim=True)
            b2 = torch.sum(b * b, -1, keepdim=True)
            sq = a2 + b2.transpose(-1, -2) - 2 * _matmul(a, b.transpose(-1, -2))
            return torch.sqrt(torch.clamp(sq, min=0.0))
        d = abs_value(a[..., :, None, :] - b[..., None, :, :])
        if p == 0:
            return torch.sum((d != 0).to(a.dtype), -1)
        if np.isinf(p):
            return torch.amax(d, -1)
        return torch.sum(d ** p, -1) ** (1.0 / p)

    return op(fn, x, y, op_name="cdist")


def take(x, index, mode="raise", name=None):
    """Flat-index gather; "raise" clamps as the reference's compiled
    gather does."""
    def fn(v, idx):
        flat = v.reshape(-1)
        n = flat.shape[0]
        i = idx.long()
        if mode == "wrap":
            i = ((i % n) + n) % n
        else:
            i = torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)
        return flat[i]

    return op(fn, x, index, op_name="take")


def logcumsumexp(x, axis=None, dtype=None, name=None):
    from ._helpers import convert_dtype

    def fn(v):
        a = v.reshape(-1) if axis is None else v
        out = torch.logcumsumexp(a.float(), 0 if axis is None else int(axis))
        return out.to(convert_dtype(dtype) or v.dtype)

    return op(fn, x, op_name="logcumsumexp")


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled down to p-norm ``max_norm``."""
    def fn(v):
        moved = torch.movedim(v, axis, 0)
        flat = moved.reshape(moved.shape[0], -1)
        norms = torch.sum(abs_value(flat) ** p, 1) ** (1.0 / p)
        s = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
        return torch.movedim((flat * s[:, None]).reshape(moved.shape), 0,
                             axis)

    return op(fn, x, op_name="renorm")


def frexp(x, name=None):
    """(mantissa, exponent) with x = m 2^e, 0.5 <= |m| < 1."""
    def fn(v):
        safe = torch.where(v == 0, torch.ones_like(v), v)
        e = torch.where(v == 0, torch.zeros_like(v),
                        torch.floor(torch.log2(torch.abs(safe))) + 1)
        return (v / torch.exp2(e)).to(v.dtype), e.to(v.dtype)

    return op(fn, x, op_name="frexp")


def _trapezoid_terms(yv, rest, dx, axis):
    if rest:
        d = torch.diff(rest[0], dim=axis)
    else:
        d = dx if dx is not None else 1.0
    n = yv.shape[axis]
    ya = yv.narrow(axis, 0, n - 1)
    yb = yv.narrow(axis, 1, n - 1)
    return (ya + yb) * 0.5 * d


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def fn(yv, *rest):
        return torch.sum(_trapezoid_terms(yv, rest, dx, axis), axis)

    args = [y] + ([x] if x is not None else [])
    return op(fn, *args, op_name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def fn(yv, *rest):
        return torch.cumsum(_trapezoid_terms(yv, rest, dx, axis), axis)

    args = [y] + ([x] if x is not None else [])
    return op(fn, *args, op_name="cumulative_trapezoid")


def vander(x, n=None, increasing=False, name=None):
    def fn(v):
        cols = n if n is not None else v.shape[0]
        powers = torch.arange(cols, device=v.device, dtype=torch.int32)
        if not increasing:
            powers = powers.flip(0)
        if v.is_floating_point():
            powers = powers.to(v.dtype)
        return v[:, None] ** powers[None, :]

    return op(fn, x, op_name="vander")


def nanmedian(x, axis=None, keepdim=False, name=None):
    return op(lambda v: _quantile(v, 0.5, axis, keepdim, torch.nanquantile,
                                  "midpoint"),
              x, op_name="nanmedian")


def polygamma(x, n, name=None):
    return op(lambda v: torch.polygamma(n, _float(v)), x,
              op_name="polygamma")


def i0(x, name=None):
    return op(lambda v: torch.i0(_float(v)), x, op_name="i0")


def i0e(x, name=None):
    return op(lambda v: torch.special.i0e(_float(v)), x, op_name="i0e")


def positive(x, name=None):
    return op(torch.positive, x, op_name="positive")


def negative(x, name=None):
    return op(torch.neg, x, op_name="negative")


def conj_physical(x, name=None):
    return op(torch.conj_physical, x, op_name="conj_physical")


def ldexp(x, y, name=None):
    def fn(a, b):
        dt = a.dtype if a.is_floating_point() else torch.float32
        return a * torch.exp2(b.to(torch.float32)).to(dt)

    return op(fn, x, y, op_name="ldexp")


def hypot(x, y, name=None):
    def fn(a, b):
        if a.dtype != b.dtype:
            dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        return torch.hypot(_float(a), _float(b))

    return op(fn, x, y, op_name="hypot")


def signbit(x, name=None):
    return op(torch.signbit, x, op_name="signbit")


def isreal(x, name=None):
    return op(torch.isreal, x, op_name="isreal")


def isposinf(x, name=None):
    return op(torch.isposinf, x, op_name="isposinf")


def isneginf(x, name=None):
    return op(torch.isneginf, x, op_name="isneginf")


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    if isinstance(inputs, Tensor):
        return inputs.clone()
    seq = list(inputs)
    if not seq:
        raise ValueError("add_n expects at least one input")

    def fn(*vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    return op(fn, *seq, op_name="add_n")


def tanh_(x, name=None):
    x._replace_from(tanh(x))
    return x
