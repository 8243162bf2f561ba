"""Numeric helpers shared by the codecs, the collectives and the update
kernels' plain versions. Nothing here imports the rest of the port.

``div_rn`` is the division the CUDA kernels do (``__fdiv_rn``). The
reference divides by Python numbers; on the card PyTorch turns a
division by a host scalar into a multiply by its reciprocal, which
rounds differently, so every plain version that must match a kernel or
the reference bit for bit divides through here.

``sqrt_rn`` is the square root the kernels do (``__fsqrt_rn``) and XLA
does: correctly rounded. On the card ``torch.sqrt`` already is. PyTorch's
CPU kernel (SLEEF, within 0.5001 ulp) misrounds some fp32 inputs; fp32
widened to fp64 has room for the exact root's rounding, so on the CPU
the root is taken in fp64 and rounded back.
"""
from __future__ import annotations

import torch

__all__ = ["div_rn", "sqrt_rn", "n_scale_blocks"]


def div_rn(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device. The divisor is a
    device tensor, not a Python number; it is filled on the device, so
    the host never waits for a copy."""
    return x / torch.full((), float(divisor), dtype=torch.float32,
                          device=x.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(x)`` correctly rounded in ``x``'s dtype (fp32) on every
    device: ``torch.sqrt`` on the card, through fp64 on the CPU, whose
    fp32 root misrounds."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def n_scale_blocks(numel: int, block_size: int) -> int:
    """Blocks of ``block_size`` elements that cover ``numel`` (the last
    one ragged): one abs-max scale each."""
    return -(-int(numel) // int(block_size))
