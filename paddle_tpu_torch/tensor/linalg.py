"""Linear algebra ops (reference: ``paddle_tpu/tensor/linalg.py``).

The decompositions are PyTorch's (LAPACK on the CPU, cuSOLVER on the
card). Where the reference's own outputs are defined only up to sign or
order (``qr``, ``svd``, ``eig``, ``eigh``'s vectors), so are these. The
reference's host ops (``eig``, ``eigvals``, ``lstsq``, ``histogram``)
run on the tensor's device here; ``lstsq`` solves by the SVD with
numpy's default cutoff, as ``numpy.linalg.lstsq`` does, and
``histogram`` bins as ``numpy.histogram`` does, in the input's float
dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import INDEX, op, val, wrap
from .math import _float, abs_value, bmm, dot, matmul, mm, mv  # noqa: F401

_INF = float("inf")


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    def fn(v):
        if axis is None:
            flat = v.reshape(-1)
            if p in ("fro", 2):
                return torch.sqrt(torch.sum(flat * flat))
            if p == 1:
                return torch.sum(abs_value(flat))
            if p == _INF:
                return torch.amax(abs_value(flat))
            if p == -_INF:
                return torch.amin(abs_value(flat))
            return torch.sum(abs_value(flat) ** p) ** (1.0 / p)
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        if p == "fro":
            return torch.sqrt(torch.sum(v * v, ax, keepdim=keepdim))
        if p == _INF:
            return torch.amax(abs_value(v), ax, keepdim=keepdim)
        if p == -_INF:
            return torch.amin(abs_value(v), ax, keepdim=keepdim)
        if p == 0:
            return torch.sum((v != 0).to(v.dtype), ax, keepdim=keepdim)
        return torch.sum(abs_value(v) ** p, ax, keepdim=keepdim) ** (1.0 / p)

    return op(fn, x, op_name="norm")


def dist(x, y, p=2, name=None):
    def fn(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.sum((d != 0).to(a.dtype))
        if p == _INF:
            return torch.amax(abs_value(d))
        if p == -_INF:
            return torch.amin(abs_value(d))
        return torch.sum(abs_value(d) ** p) ** (1.0 / p)

    return op(fn, x, y, op_name="dist")


def cond(x, p=None, name=None):
    return op(lambda v: torch.linalg.cond(v, p), x)


def _first_dim3(x):
    for i, s in enumerate(val(x).shape):
        if s == 3:
            return i
    return -1


def cross(x, y, axis=9, name=None):
    ax = axis if axis != 9 else _first_dim3(x)
    return op(lambda a, b: torch.linalg.cross(a, b, dim=ax), x, y,
              op_name="cross")


def cholesky(x, upper=False, name=None):
    def fn(v):
        L = torch.linalg.cholesky(v)
        return L.transpose(-1, -2) if upper else L

    return op(fn, x, op_name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    """Solves with the factor's triangle; the other triangle is not read
    (nor differentiated), as in the reference."""
    return op(lambda b, L: torch.cholesky_solve(
        b, L.triu() if upper else L.tril(), upper=upper), x, y)


def qr(x, mode="reduced", name=None):
    return op(lambda v: tuple(torch.linalg.qr(v, mode=mode)), x,
              op_name="qr")


def svd(x, full_matrices=False, name=None):
    return op(lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), x, op_name="svd")


def eig(x, name=None):
    w, v = torch.linalg.eig(val(x).detach())
    return wrap(w), wrap(v)


def eigh(x, UPLO="L", name=None):
    return op(lambda v: tuple(torch.linalg.eigh(v, UPLO=UPLO)), x,
              op_name="eigh")


def eigvals(x, name=None):
    return wrap(torch.linalg.eigvals(val(x).detach()))


def eigvalsh(x, UPLO="L", name=None):
    return op(lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO), x)


def inv(x, name=None):
    return op(torch.linalg.inv, x, op_name="inv")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return op(lambda v: torch.linalg.pinv(v, rtol=rcond,
                                          hermitian=hermitian), x)


def solve(x, y, name=None):
    return op(torch.linalg.solve, x, y, op_name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return op(fn, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) as numpy's ``lstsq``
    gives them: residuals only when the rank is full and m > n."""
    a, b = val(x).detach(), val(y).detach()
    m, n = a.shape
    cut = np.finfo(np.float32).eps * max(m, n) if rcond is None else rcond
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    keep = s > cut * s[0]
    inv_s = torch.where(keep, 1.0 / s, torch.zeros_like(s))
    b2 = b if b.ndim == 2 else b[:, None]
    sol = vh.transpose(-1, -2) @ (inv_s[:, None] * (u.transpose(-1, -2)
                                                    @ b2))
    rank = keep.sum()
    if int(rank) == n and m > n:
        res = torch.sum((a @ sol - b2) ** 2, 0)
    else:
        res = torch.zeros(0, dtype=a.dtype, device=a.device)
    if b.ndim == 1:
        sol = sol[:, 0]
        res = res.reshape(-1)
    return wrap(sol), wrap(res), wrap(rank.to(INDEX)), wrap(s)


def lu(x, pivot=True, get_infos=False, name=None):
    lu_mat, piv = torch.linalg.lu_factor(val(x).detach())
    outs = [wrap(lu_mat), wrap(piv.to(torch.int32))]
    if get_infos:
        outs.append(wrap(torch.zeros((), dtype=torch.int32,
                                     device=lu_mat.device)))
    return tuple(outs)


def matrix_power(x, n, name=None):
    return op(lambda v: torch.linalg.matrix_power(v, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return op(lambda v: torch.linalg.matrix_rank(v, rtol=tol).to(INDEX), x)


def det(x, name=None):
    return op(torch.linalg.det, x, op_name="det")


def slogdet(x, name=None):
    def fn(v):
        sign, logdet = torch.linalg.slogdet(v)
        return torch.stack([sign, logdet])

    return op(fn, x)


def multi_dot(x, name=None):
    return op(lambda *vs: torch.linalg.multi_dot(vs), *x)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of ``bins`` equal bins over [min, max] (the data's range when
    both are 0), the last bin closed, as ``numpy.histogram`` bins: the
    edges by its ``linspace`` (in float64 for a given range, in the
    data's dtype for the data's own), the bin by its scaled index and its
    two corrections against the edges."""
    v = val(input).detach().reshape(-1)
    cd = v.dtype if v.is_floating_point() else torch.float64
    a = v.to(cd)
    dev = v.device
    if min != 0 or max != 0:
        lo, hi = float(min), float(max)
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.arange(bins + 1, dtype=torch.float64, device=dev)
        edges = edges * ((hi - lo) / bins) + lo
        edges[-1] = hi
        edges = edges.to(cd)
        lo_t = torch.tensor(lo, dtype=cd, device=dev)
        hi_t = torch.tensor(hi, dtype=cd, device=dev)
    else:
        lo_t, hi_t = a.amin(), a.amax()
        if bool(lo_t == hi_t):
            lo_t, hi_t = lo_t - 0.5, hi_t + 0.5
        edges = torch.arange(bins + 1, dtype=cd, device=dev)
        edges = edges * ((hi_t - lo_t) / bins) + lo_t
        edges[-1] = hi_t
    a = a[(a >= lo_t) & (a <= hi_t)]
    idx = ((a - lo_t) / (hi_t - lo_t) * bins).long()
    idx = torch.where(idx == bins, idx - 1, idx)
    idx = idx - (a < edges[idx]).long()
    idx = idx + ((a >= edges[idx + 1]) & (idx != bins - 1)).long()
    return wrap(torch.bincount(idx, minlength=bins).to(INDEX))


def bincount(x, weights=None, minlength=0, name=None):
    v = val(x)
    n = int(max(int(v.max()) + 1 if v.numel() else 0, minlength))
    if weights is not None:
        return op(lambda c, w: torch.zeros(n, dtype=w.dtype,
                                           device=w.device).index_add(
                                               0, c.long(), w),
                  x, weights)
    return op(lambda c: torch.bincount(c.long(), minlength=n), x)


def corrcoef(x, rowvar=True, name=None):
    return op(lambda v: torch.corrcoef(_float(v) if rowvar
                                       else _float(v).transpose(0, 1)), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return op(lambda v: torch.cov(_float(v) if rowvar
                                  else _float(v).transpose(0, 1),
                                  correction=1 if ddof else 0), x)
