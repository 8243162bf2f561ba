"""TF32 rounding and the split-TF32 representation of fp32 operands (no
reference file: new). Plain PyTorch models of what the tensor-core
kernels (``csrc/quant_matmul.cu``, ``csrc/flash_attention.cu``) do to
their operands, for the CPU tests and for reading the kernels.

TF32 keeps fp32's sign and exponent and the top 10 of its 23 mantissa
bits. ``tf32_rna`` rounds to the nearest TF32 value, ties away from zero,
as the kernels' ``cvt.rna.tf32.f32`` does. ``split_tf32`` writes an fp32
tensor as ``big + small`` with both TF32: ``big = tf32_rna(x)``,
``small = tf32_rna(x - big)``, leaving at most about ``2^-22 |x|``
out. A product of two split operands takes three TF32 products
(``big.big + big.small + small.big``, "3xTF32"); an operand that TF32
holds exactly, as int8 weights, needs two.

``split_tf32_trunc`` is the split of the flash backward kernels
(``split_tf32_trunc`` in ``csrc/mma_tf32.cuh``): ``big`` the same, but
``small = tf32_trunc(x - big)``, the low 13 bits dropped as the tensor
cores drop them, leaving at most about ``2^-21 |x|`` out.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["tf32_rna", "tf32_trunc", "split_tf32", "split_tf32_trunc"]

_LOW = 0x1FFF   # the 13 mantissa bits TF32 drops


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32, to nearest, ties away from zero
    (``cvt.rna.tf32.f32``); infinities and NaNs pass through."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    rounded = ((bits + (_LOW + 1) // 2) & ~_LOW).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)``, both TF32 values in fp32 tensors, with
    ``big + small`` within about ``2^-22 |x|`` of ``x``."""
    big = tf32_rna(x)
    return big, tf32_rna(x.to(torch.float32) - big)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` with the 13 mantissa bits TF32 drops cleared (toward
    zero); infinities and NaNs pass through."""
    x = x.to(torch.float32).contiguous()
    truncated = (x.view(torch.int32) & ~_LOW).view(torch.float32)
    return torch.where(torch.isfinite(x), truncated, x)


def split_tf32_trunc(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)``: ``big`` as in ``split_tf32``, ``small`` the rest
    truncated to TF32; ``big + small`` within about ``2^-21 |x|`` of
    ``x``."""
    big = tf32_rna(x)
    return big, tf32_trunc(x.to(torch.float32) - big)
