"""Numeric helpers shared by the codecs, the collectives and the update
kernels' plain versions. Nothing here imports the rest of the port.

``div_rn`` is the division the CUDA kernels do (``__fdiv_rn``). The
reference divides by Python numbers; on the card PyTorch turns a
division by a host scalar into a multiply by its reciprocal, which
rounds differently, so every plain version that must match a kernel or
the reference bit for bit divides through here.
"""
from __future__ import annotations

import torch

__all__ = ["div_rn", "n_scale_blocks"]


def div_rn(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device. The divisor is a
    device tensor, not a Python number; it is filled on the device, so
    the host never waits for a copy."""
    return x / torch.full((), float(divisor), dtype=torch.float32,
                          device=x.device)


def n_scale_blocks(numel: int, block_size: int) -> int:
    """Blocks of ``block_size`` elements that cover ``numel`` (the last
    one ragged): one abs-max scale each."""
    return -(-int(numel) // int(block_size))
