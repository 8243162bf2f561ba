"""The op namespace and the ``Tensor`` methods (reference:
``paddle_tpu/tensor/__init__.py``: the namespace, the method table
``_METHODS`` and the operator dunders set on ``Tensor``).

Every op takes the port's eager ``Tensor`` or a plain ``torch.Tensor``.
Given an eager ``Tensor`` it returns one, with the reference's dtypes;
given plain ``torch.Tensor``s it returns a plain ``torch.Tensor``. The
models call the ops that the reference dispatches on their paths that
way (``add``, ``reshape``, ``flatten``, ``getitem``, ``where``,
``less_than``, ``unsqueeze``, ``zeros_like``), so each is a cast point
under ``amp`` with the reference's op name, and with no amp active the
plain PyTorch op.

The random ops (``tensor/random.py``, with ``shuffle_batch``) draw
from the port's explicit generators (``framework/random.py``), not
JAX's threefry bits.
"""
from __future__ import annotations

import types as _types

from ..framework.autograd import call_op as _call_op
from ..framework.tensor import Tensor

from .attribute import is_complex, is_floating_point, is_integer, rank, shape  # noqa: F401
from .creation import (  # noqa: F401
    arange, assign, clone, complex, diag, diagflat, empty, empty_like, eye,
    full, full_like, imag, linspace, logspace, meshgrid, numel, ones,
    ones_like, real, to_tensor, tril, triu, zeros, zeros_like,
)
from .einsum import einsum  # noqa: F401
from .random import (  # noqa: F401
    bernoulli, exponential_, multinomial, normal, normal_, poisson, rand,
    rand_like, randint, randint_like, randn, randn_like, randperm,
    shuffle_batch, standard_normal, uniform, uniform_,
)
from .linalg import (  # noqa: F401
    bincount, bmm, cholesky, cholesky_solve, cond, corrcoef, cov, cross, det,
    dist, dot, eig, eigh, eigvals, eigvalsh, histogram, inv, lstsq, lu,
    matmul, matrix_power, matrix_rank, mm, multi_dot, mv, norm, pinv, qr,
    slogdet, solve, svd, triangular_solve,
)
from .logic import (  # noqa: F401
    allclose, bitwise_and, bitwise_not, bitwise_or, bitwise_xor, equal,
    equal_all, greater_equal, greater_than, is_empty, is_tensor, isclose,
    less_equal, less_than, logical_and, logical_not, logical_or, logical_xor,
    not_equal,
)
from .manipulation import (  # noqa: F401
    as_complex, as_real, atleast_1d, atleast_2d, atleast_3d,
    broadcast_tensors, broadcast_to, cast, chunk, concat, expand, expand_as,
    flatten, flip, gather, gather_nd, index_sample, index_select,
    masked_fill, masked_select, moveaxis, put_along_axis, repeat_interleave,
    reshape, reshape_, roll, rot90, scatter, scatter_, scatter_nd,
    scatter_nd_add, slice, split, squeeze, squeeze_, stack, strided_slice,
    swapaxes, t, take_along_axis, tensordot, tile, transpose, unbind, unique,
    unique_consecutive, unsqueeze, unsqueeze_, unstack, view, unflatten,
    as_strided, tensor_split, hsplit, vsplit, dsplit, hstack, vstack, dstack,
    column_stack, row_stack, crop, index_add, index_put, masked_scatter,
    reverse, diagonal, multiplex, shard_index, fill_diagonal, fill_diagonal_,
    partial_concat, partial_sum, pad_constant_like,
)
from .math import (  # noqa: F401
    add_n, tanh_,
    abs, acos, acosh, add, add_, addmm, all, amax, amin, angle, any, asin,
    asinh, atan, atan2, atanh, ceil, clip, clip_, conj, copysign, cos, cosh,
    count_nonzero, cummax, cummin, cumprod, cumsum, deg2rad, diff, digamma,
    divide, divide_, erf, erfinv, exp, expm1, floor, floor_divide, floor_mod,
    fmax, fmin, frac, gcd, heaviside, increment, inner, isfinite, isinf,
    isnan, kron, lcm, lerp, lgamma, log, log1p, log2, log10, logaddexp,
    logit, logsumexp, max, maximum, mean, median, min, minimum, mm, mod,
    multiply, multiply_, nan_to_num, nanmean, nansum, neg, nextafter, outer,
    pow, prod, quantile, rad2deg, reciprocal, remainder, round, rsqrt, scale,
    scale_, sigmoid, sign, sin, sinh, sqrt, square, stanh, std, subtract,
    subtract_, sum, tan, tanh, trace, trunc, var,
    cdist, take, logcumsumexp, renorm, frexp, trapezoid,
    cumulative_trapezoid, vander, nanmedian, polygamma, i0, i0e,
    positive, negative, conj_physical, ldexp, hypot, signbit, isreal,
    isposinf, isneginf, broadcast_shape,
)
from .search import (  # noqa: F401
    argmax, argmin, argsort, bucketize, kthvalue, mode, nonzero,
    searchsorted, sort, topk, where, where_,
)


def getitem(x, idx):
    """``x[idx]`` as the reference's ``Tensor.__getitem__`` dispatches it
    (the op "getitem"), for a ``Tensor`` or a plain ``torch.Tensor``."""
    if isinstance(x, Tensor):
        return x[idx]
    return _call_op(lambda v: v[idx], x, op_name="getitem")


# ------------------------------------------------------------------ patching
_METHODS = dict(
    # math
    abs=abs, acos=acos, acosh=acosh, add=add, add_=add_, addmm=addmm, all=all,
    amax=amax, amin=amin, angle=angle, any=any, asin=asin, asinh=asinh,
    atan=atan, atanh=atanh, ceil=ceil, clip=clip, clip_=clip_, conj=conj,
    cos=cos, cosh=cosh, count_nonzero=count_nonzero, cumprod=cumprod,
    cumsum=cumsum, digamma=digamma, divide=divide, divide_=divide_, erf=erf,
    erfinv=erfinv, exp=exp, expm1=expm1, floor=floor,
    floor_divide=floor_divide, floor_mod=floor_mod, fmax=fmax, fmin=fmin,
    frac=frac, inner=inner, isfinite=isfinite, isinf=isinf, isnan=isnan,
    kron=kron, lerp=lerp, lgamma=lgamma, log=log, log1p=log1p, log2=log2,
    log10=log10, logit=logit, logsumexp=logsumexp, max=max, maximum=maximum,
    mean=mean, median=median, min=min, minimum=minimum, mod=mod,
    multiply=multiply, multiply_=multiply_, nan_to_num=nan_to_num,
    nanmean=nanmean, nansum=nansum, neg=neg, outer=outer, pow=pow, prod=prod,
    quantile=quantile, reciprocal=reciprocal, remainder=remainder,
    round=round, rsqrt=rsqrt, scale=scale, scale_=scale_, sigmoid=sigmoid,
    sign=sign, sin=sin, sinh=sinh, sqrt=sqrt, square=square, std=std,
    subtract=subtract, subtract_=subtract_, sum=sum, tan=tan, tanh=tanh,
    trace=trace, trunc=trunc, var=var,
    # linalg
    bincount=bincount, bmm=bmm, cholesky=cholesky, cross=cross, det=det,
    dist=dist, dot=dot, eigvals=eigvals, histogram=histogram, inverse=inv,
    matmul=matmul, matrix_power=matrix_power, mm=mm, mv=mv, norm=norm, qr=qr,
    # logic
    allclose=allclose, bitwise_and=bitwise_and, bitwise_not=bitwise_not,
    bitwise_or=bitwise_or, bitwise_xor=bitwise_xor, equal=equal,
    equal_all=equal_all, greater_equal=greater_equal,
    greater_than=greater_than, isclose=isclose, less_equal=less_equal,
    less_than=less_than, logical_and=logical_and, logical_not=logical_not,
    logical_or=logical_or, logical_xor=logical_xor, not_equal=not_equal,
    # manipulation
    broadcast_to=broadcast_to, chunk=chunk, expand=expand,
    expand_as=expand_as, flatten=flatten, flip=flip, gather=gather,
    gather_nd=gather_nd, index_sample=index_sample,
    index_select=index_select, masked_fill=masked_fill,
    masked_select=masked_select, moveaxis=moveaxis,
    repeat_interleave=repeat_interleave, reshape=reshape, reshape_=reshape_,
    roll=roll, rot90=rot90, scatter=scatter, scatter_=scatter_,
    scatter_nd_add=scatter_nd_add, slice=slice, split=split,
    squeeze=squeeze, squeeze_=squeeze_, strided_slice=strided_slice,
    swapaxes=swapaxes, take_along_axis=take_along_axis, tile=tile,
    transpose=transpose, unbind=unbind, unique=unique, unsqueeze=unsqueeze,
    unsqueeze_=unsqueeze_, unstack=unstack,
    # search
    argmax=argmax, argmin=argmin, argsort=argsort, kthvalue=kthvalue,
    nonzero=nonzero, sort=sort, topk=topk, where=where,
    # the rest of the reference's method surface (concat and stack take
    # lists, not methods, as there)
    diag=diag, t=t, tril=tril, triu=triu,
    # random
    bernoulli=bernoulli, exponential_=exponential_, multinomial=multinomial,
    normal_=normal_, uniform_=uniform_,
)


def _make_method(fn):
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)

    method.__name__ = fn.__name__
    return method


for _name, _fn in _METHODS.items():
    setattr(Tensor, _name, _make_method(_fn))


def _binop(fn, reflexive=False):
    if reflexive:
        def method(self, other):
            return fn(other, self)
    else:
        def method(self, other):
            return fn(self, other)
    return method


Tensor.__add__ = _binop(add)
Tensor.__radd__ = _binop(add, True)
Tensor.__sub__ = _binop(subtract)
Tensor.__rsub__ = _binop(subtract, True)
Tensor.__mul__ = _binop(multiply)
Tensor.__rmul__ = _binop(multiply, True)
Tensor.__truediv__ = _binop(divide)
Tensor.__rtruediv__ = _binop(divide, True)
Tensor.__floordiv__ = _binop(floor_divide)
Tensor.__rfloordiv__ = _binop(floor_divide, True)
Tensor.__mod__ = _binop(remainder)
Tensor.__pow__ = _binop(pow)
Tensor.__rpow__ = _binop(pow, True)
Tensor.__matmul__ = _binop(matmul)
Tensor.__rmatmul__ = _binop(matmul, True)
Tensor.__neg__ = lambda self: neg(self)
Tensor.__abs__ = lambda self: abs(self)
Tensor.__invert__ = lambda self: logical_not(self)
Tensor.__eq__ = _binop(equal)
Tensor.__ne__ = _binop(not_equal)
Tensor.__lt__ = _binop(less_than)
Tensor.__le__ = _binop(less_equal)
Tensor.__gt__ = _binop(greater_than)
Tensor.__ge__ = _binop(greater_equal)
Tensor.__and__ = _binop(logical_and)
Tensor.__or__ = _binop(logical_or)
Tensor.__xor__ = _binop(logical_xor)
Tensor.__hash__ = lambda self: id(self)

__all__ = sorted(n for n, v in globals().items()
                 if not n.startswith("_") and callable(v)
                 and not isinstance(v, _types.ModuleType))
