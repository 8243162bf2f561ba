"""Blockwise codec math in plain PyTorch and the gradient bucket plan
(reference: ``paddle_tpu/distributed/grad_comm.py`` ``_QMAX``,
``_as_blocks``, ``block_absmax``, ``block_scales``, ``block_encode``,
``block_decode``, ``GradBucket``, ``build_buckets``).

One fp32 abs-max scale per ``block_size`` elements; ``int8_block``
rounds half-to-even and clips to +-127, ``fp8_block`` casts to
float8_e4m3fn. These are the plain versions of the CUDA kernels in
``csrc/codec.cu`` (``ops/codec.py`` dispatches between the two) and
match the reference's payload bits.

The reference returns the payload in a wider carrier (int32, fp32) so
it can be summed over ranks on the gradient wire. Serving stores the
payload at rest, so the port returns the wire dtype itself (int8 or
float8_e4m3fn); the carriers arrive with the gradient-wire slice.

fp8 range: ``scales = absmax / 448`` keeps ``|x / s| <= 448 * (1 + ulp)``,
which rounds to 448, so the cast never sees an out-of-range value
(where torch saturates and ml_dtypes gives NaN, the two would differ).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["BLOCK_CODECS", "QMAX", "WIRE_DTYPE", "n_scale_blocks",
           "as_blocks", "block_absmax", "block_scales", "block_encode",
           "block_decode", "GradBucket", "build_buckets"]

BLOCK_CODECS = ("int8_block", "fp8_block")
# largest representable magnitude of the wire format
QMAX = {"int8_block": 127.0, "fp8_block": 448.0}
WIRE_DTYPE = {"int8_block": torch.int8, "fp8_block": torch.float8_e4m3fn}


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device. The divisor is a
    device tensor, not a Python number: PyTorch's CUDA kernels turn a
    division by a host scalar into a multiply by its reciprocal, which
    is not the quotient the reference (and the kernel) computes. The
    tensor is filled on the device, so the host never waits for a copy."""
    return x / torch.full((), float(divisor), dtype=torch.float32,
                          device=x.device)


def n_scale_blocks(numel: int, block_size: int) -> int:
    return -(-int(numel) // int(block_size))


def as_blocks(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n_blocks, block_size) fp32 view of a flat buffer, zero-padded."""
    flat = flat.reshape(-1).to(torch.float32)
    pad = n_scale_blocks(flat.numel(), block_size) * block_size - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block_size)


def block_absmax(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block abs-max (fp32 vector of n_blocks entries)."""
    return as_blocks(flat, block_size).abs().amax(dim=1)


def block_scales(absmax: torch.Tensor, codec: str) -> torch.Tensor:
    """Quantization step per block from the abs-max."""
    return _div(absmax.to(torch.float32).clamp_min(1e-12), QMAX[codec])


def block_encode(flat: torch.Tensor, scales: torch.Tensor, block_size: int,
                 codec: str) -> torch.Tensor:
    """Blockwise quantize with ``scales`` -> wire dtype [n_blocks, bs]."""
    q = as_blocks(flat, block_size) / scales[:, None]
    if codec == "int8_block":
        return torch.round(q).clamp_(-127, 127).to(torch.int8)
    return q.to(torch.float8_e4m3fn)


def block_decode(q: torch.Tensor, scales: torch.Tensor, world: int,
                 numel: int) -> torch.Tensor:
    """Dequantize a [n_blocks, bs] payload to fp32 [numel], averaged
    over ``world`` replicas (1 for the KV cache)."""
    vals = q.to(torch.float32) * scales[:, None]
    return _div(vals.reshape(-1)[:numel], world)


# ------------------------------------------------------------------ buckets
# (reference: ``GradBucket``, ``build_buckets`` and ``_MB``)
_MB = 1024 * 1024


class GradBucket:
    """One dtype-homogeneous flat bucket: which parameters it holds, in
    order, and where each starts."""

    __slots__ = ("index", "dtype", "param_indices", "shapes", "numels",
                 "offsets", "size")

    def __init__(self, index: int, dtype: torch.dtype):
        self.index = index
        self.dtype = dtype
        self.param_indices: List[int] = []   # positions in the param list
        self.shapes: List[tuple] = []
        self.numels: List[int] = []
        self.offsets: List[int] = []         # start offset of each param
        self.size = 0                        # total elements in the bucket

    def add(self, param_index: int, shape: Sequence[int]):
        n = math.prod(shape)
        self.param_indices.append(param_index)
        self.shapes.append(tuple(shape))
        self.numels.append(n)
        self.offsets.append(self.size)
        self.size += n

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __repr__(self):
        return (f"GradBucket(#{self.index}, dtype={self.dtype}, "
                f"params={len(self.param_indices)}, numel={self.size})")


def build_buckets(params, comm_buffer_size: float = 25,
                  last_comm_buffer_size: float = 1,
                  dtypes: Optional[Sequence] = None) -> List[GradBucket]:
    """Assign parameters to dtype-homogeneous flat buckets, walking them in
    reverse order (the order backward produces gradients). The first
    bucket's cap is ``last_comm_buffer_size`` MB, every later bucket's
    ``comm_buffer_size`` MB; a parameter larger than the cap gets a bucket
    of its own."""
    params = list(params)
    if dtypes is None:
        dtypes = [p.dtype for p in params]
    buckets: List[GradBucket] = []
    open_by_dtype = {}
    for pi in reversed(range(len(params))):
        dt = dtypes[pi]
        shape = tuple(params[pi].shape)
        numel = math.prod(shape)
        b = open_by_dtype.get(dt)
        if b is not None:
            cap_mb = (last_comm_buffer_size if b.index == 0
                      else comm_buffer_size)
            if b.size > 0 and (b.size + numel) * dt.itemsize > cap_mb * _MB:
                b = None
        if b is None:
            b = GradBucket(len(buckets), dt)
            buckets.append(b)
            open_by_dtype[dt] = b
        b.add(pi, shape)
    return buckets
