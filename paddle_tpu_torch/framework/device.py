"""Device resolution for the port (reference: ``paddle_tpu/framework/target.py``).

The JAX package asks "what platform is this program compiled for"; the
port asks "which torch device does this entry point run on". The answer
is CUDA unless the caller explicitly passes ``device="cpu"`` (the CPU
tests do). A CUDA request on a machine without a card raises: nothing
falls back to the CPU behind the caller's back.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["resolve_device", "require_sm90", "to_device"]


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" (the default) must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: CUDA device requested but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch path explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def to_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host data (numpy, list, CPU tensor) as a ``dtype`` tensor on
    ``device`` without stalling the host. A plain host-to-card copy
    synchronizes the stream; this one goes through pinned memory with
    ``non_blocking=True`` and returns while the copy is queued (the
    caching host allocator keeps the pinned buffer until it is done)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            return x.to(device, dtype)
        t = x.to(dtype)
    else:
        t = torch.as_tensor(np.asarray(x)).to(dtype)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def require_sm90(device: torch.device) -> None:
    """The hand-written kernels are built for ``sm_90a`` (Hopper) only."""
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"paddle_tpu_torch kernels target sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}")
