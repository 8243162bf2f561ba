"""Dtypes (reference: ``paddle_tpu/framework/dtype.py``).

A dtype of the port is a ``torch.dtype``: ``paddle_tpu_torch.float32``
is ``torch.float32``. ``convert_dtype`` takes what the reference takes
(a name such as "float32" or "bf16", a numpy dtype or type, a Python
type, a ``torch.dtype``) and gives the dtype the reference would hold.

The reference runs JAX with 64-bit types off and narrows them
explicitly (``dtype.py:51-87``): int64 becomes int32, float64 float32,
complex128 complex64. So ``to_tensor([1, 2])`` is int32 there, an
``argmax`` is int32, and float64 data becomes float32. The port keeps
that rule here, in one place: ``convert_dtype`` narrows every request,
and ``NARROW`` is what the eager ``Tensor`` applies to each op's result
(``framework/tensor.py`` ``_wrap``). Plain ``torch.Tensor``s that the
models pass through the tensor ops keep PyTorch's own dtypes.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

__all__ = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "is_floating_point", "is_integer",
           "is_complex", "set_default_dtype", "get_default_dtype", "NARROW",
           "cast_value"]

bool = torch.bool  # noqa: A001 - mirrors paddle.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "bool": bool, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "half": float16, "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
}

_NUMPY = {np.dtype(n): d for n, d in (
    ("bool", bool), ("uint8", uint8), ("int8", int8), ("int16", int16),
    ("int32", int32), ("int64", int64), ("float16", float16),
    ("float32", float32), ("float64", float64), ("complex64", complex64),
    ("complex128", complex128))}

# the reference's x64-off narrowing (its ``_NARROW``)
NARROW = {int64: int32, float64: float32, complex128: complex64}

_FLOATING = {float16, bfloat16, float32, float64}
_INTEGER = {uint8, int8, int16, int32, int64}
_COMPLEX = {complex64, complex128}

_NAMES = {d: n for n, d in _STR_ALIASES.items()
          if n in ("bool", "uint8", "int8", "int16", "int32", "int64",
                   "float16", "bfloat16", "float32", "float64",
                   "complex64", "complex128")}


def _to_torch(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        d = _STR_ALIASES.get(dtype)
        if d is not None:
            return d
        try:
            return _NUMPY[np.dtype(dtype)]
        except (TypeError, KeyError):
            raise ValueError(f"Unknown dtype string: {dtype!r}") from None
    if getattr(dtype, "name", None) == "bfloat16":   # ml_dtypes' bfloat16
        return bfloat16
    try:
        return _NUMPY[np.dtype(dtype)]
    except (TypeError, KeyError):
        raise ValueError(f"Cannot convert {dtype!r} to a dtype") from None


def convert_dtype(dtype):
    """Any dtype spec as the ``torch.dtype`` the reference holds (64-bit
    types narrowed); None stays None."""
    if dtype is None:
        return None
    d = _to_torch(dtype)
    return NARROW.get(d, d)


def dtype_name(dtype) -> str:
    """The reference's name of a dtype ("float32", "bfloat16", ...)."""
    return _NAMES[convert_dtype(dtype)]


def is_floating_point(dtype) -> builtins.bool:
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype) -> builtins.bool:
    d = convert_dtype(dtype)
    return d in _INTEGER or d == bool


def is_complex(dtype) -> builtins.bool:
    return convert_dtype(dtype) in _COMPLEX


_DEFAULT_DTYPE = [float32]


def set_default_dtype(d) -> None:
    """``paddle.set_default_dtype``: a floating dtype only."""
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            f"set_default_dtype only supports floating dtypes, got {d}")
    _DEFAULT_DTYPE[0] = d


def get_default_dtype() -> torch.dtype:
    return _DEFAULT_DTYPE[0]


def cast_value(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``v.to(dt)`` as the reference casts: a float cast to an integer
    dtype saturates at the dtype's bounds and sends NaN to 0 (XLA's
    convert), where PyTorch's conversion wraps or is undefined out of
    range."""
    if not v.is_floating_point() or dt.is_floating_point or dt.is_complex \
            or dt == torch.bool:
        return v.to(dt)
    info = torch.iinfo(dt)
    w = v.to(torch.float64)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    out = w.clamp(info.min, info.max).to(dt)
    if info.bits == 64:     # 2**63 - 1 is no float64: 2**63 would wrap
        out = torch.where(w >= 2.0 ** 63, torch.full_like(out, info.max),
                          out)
    return out
