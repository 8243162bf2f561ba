"""Blockwise codec wrappers (reference: ``paddle_tpu/ops/pallas/codec.py``
``block_encode``/``block_decode``).

Dispatch is by where the tensor lies, and nothing else:

  CPU tensor  -> the plain PyTorch version (``distributed/grad_comm.py``);
  CUDA tensor -> the hand-written kernel (``csrc/codec.cu``), or raise.

There is no fallback from the kernel to the plain version. Each wrapper
counts its kernel launches in a plain integer attribute
(``block_encode.launches``, ``block_decode.launches``), incremented only
where the kernel is launched, so a run can show its path went through
the kernel; ``block_encode.shapes`` counts its launches by ``(n_blocks,
block_size, codec, carrier)`` and ``block_encode.dtypes`` by the input's
dtype. The counts are updated under one lock: the serving replicas
launch from several threads, and an unlocked read-modify-write can lose
a count. The wrappers check device, dtype, shape and contiguity, allocate
outputs with ``torch.empty`` (or write the caller's ``out=``) and never
synchronize; the kernel runs on PyTorch's current stream. The encode
reads an fp32, bf16 or fp16 input, a ragged one (``numel`` not a
multiple of the block) included, in place: no padded or fp32 copy is
made. The decode writes fp32 or, with ``dtype=torch.bfloat16`` or
``torch.float16``, that dtype rounded once to nearest even (fp16
subnormals kept, overflow to inf, as the plain ``.to(dtype)`` rounds).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from ..distributed import grad_comm as _plain
from ..framework.device import require_sm90
from ._build import load_library

__all__ = ["block_encode", "block_decode", "launch_counts",
           "reset_launch_counts", "KERNEL_SOURCE"]

KERNEL_SOURCE = "paddle_tpu_torch/csrc/codec.cu"
_CODEC_ID = {"int8_block": 0, "fp8_block": 1}
# payload types codec_decode reads: the 1-byte wire dtypes and the
# gradient wire's carriers (summed over ranks)
_WIRE_ID = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.int32: 2,
            torch.float32: 3}
# element types of the encode's input and the decode's output
_ELEM_ID = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _lib(device_index: int) -> ctypes.CDLL:
    require_sm90(torch.device("cuda", device_index))
    lib = load_library("codec")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.codec_encode.argtypes = [p, p, p, i64, i64, i64, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, p]
    lib.codec_encode.restype = ctypes.c_int
    lib.codec_decode.argtypes = [p, p, p, i64, i64, i64, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int, p]
    lib.codec_decode.restype = ctypes.c_int
    return lib


def _check_operand(name: str, t: torch.Tensor, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_block_size(block_size: int):
    if block_size % 4:
        raise ValueError(f"the CUDA codec needs block_size % 4 == 0, got "
                         f"{block_size}")


def block_encode(flat: torch.Tensor, scales: torch.Tensor, block_size: int,
                 codec: str, carrier: bool = False,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Quantize ``flat`` (fp32, bf16 or fp16) blockwise with ``scales`` ->
    [n_blocks, block_size] in the wire dtype (int8 or float8_e4m3fn) or,
    with ``carrier=True``, in the gradient wire's carrier (int32 or
    fp32); into ``out`` when given (that shape and dtype, contiguous)."""
    if codec not in _CODEC_ID:
        raise ValueError(f"codec must be one of {tuple(_CODEC_ID)}, "
                         f"got {codec!r}")
    if flat.device.type == "cpu":
        return _plain.block_encode(flat, scales, block_size, codec,
                                   carrier=carrier, out=out)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if flat.dtype not in _ELEM_ID or scales.dtype != torch.float32:
        raise TypeError(f"block_encode wants fp32, bf16 or fp16 input and "
                        f"fp32 scales, got {flat.dtype} and {scales.dtype}")
    _check_block_size(block_size)
    flat = flat.reshape(-1)
    nb = _plain.n_scale_blocks(flat.numel(), block_size)
    if scales.shape != (nb,):
        raise ValueError(f"scales shape {tuple(scales.shape)}, expected "
                         f"({nb},)")
    dev = flat.device
    _check_operand("flat", flat, dev)
    _check_operand("scales", scales, dev)
    out_dtype = (_plain.CARRIER_DTYPE[codec] if carrier
                 else _plain.WIRE_DTYPE[codec])
    if out is None:
        out = torch.empty((nb, block_size), dtype=out_dtype, device=dev)
    elif out.shape != (nb, block_size) or out.dtype != out_dtype:
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, expected "
                         f"{out_dtype} ({nb}, {block_size})")
    _check_operand("out", out, dev)
    if not nb:
        return out
    lib = _lib(dev.index)
    with torch.cuda.device(dev):
        rc = lib.codec_encode(flat.data_ptr(), scales.data_ptr(),
                              out.data_ptr(), flat.numel(), nb, block_size,
                              _CODEC_ID[codec], int(bool(carrier)),
                              _ELEM_ID[flat.dtype],
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"codec_encode launch failed: CUDA error {rc}")
    _count_encode((nb, block_size, codec, bool(carrier)), flat.dtype)
    return out


def block_decode(q: torch.Tensor, scales: torch.Tensor, world: int,
                 numel: int, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Dequantize a [n_blocks, bs] payload -> [numel] of ``dtype`` (fp32,
    bf16 or fp16): the first ``numel`` values of ``q * scale / world``,
    computed in fp32 and rounded once to ``dtype``. ``q`` is the wire
    dtype or a carrier."""
    if q.device.type == "cpu":
        return _plain.block_decode(q, scales, world, numel, dtype=dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if dtype not in _ELEM_ID:
        raise TypeError(f"block_decode writes fp32, bf16 or fp16, not "
                        f"{dtype}")
    if q.dtype not in _WIRE_ID:
        raise TypeError(f"block_decode wants an int8 or float8_e4m3fn "
                        f"payload or an int32/fp32 carrier, got {q.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError("block_decode wants fp32 scales")
    if q.dim() != 2:
        raise ValueError(f"payload must be [n_blocks, bs], got "
                         f"{tuple(q.shape)}")
    nb, bs = q.shape
    _check_block_size(bs)
    if scales.shape != (nb,):
        raise ValueError(f"scales shape {tuple(scales.shape)}, expected "
                         f"({nb},)")
    if not 0 <= numel <= nb * bs:
        raise ValueError(f"numel {numel} outside [0, {nb * bs}]")
    dev = q.device
    _check_operand("q", q, dev)
    _check_operand("scales", scales, dev)
    out = torch.empty((numel,), dtype=dtype, device=dev)
    if not numel:
        return out
    lib = _lib(dev.index)
    with torch.cuda.device(dev):
        rc = lib.codec_decode(q.data_ptr(), scales.data_ptr(), out.data_ptr(),
                              nb, bs, numel, _WIRE_ID[q.dtype], float(world),
                              _ELEM_ID[dtype],
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"codec_decode launch failed: CUDA error {rc}")
    _count_decode(dtype)
    return out


block_encode.launches = 0
block_encode.shapes = collections.Counter()
block_encode.dtypes = collections.Counter()
block_decode.launches = 0
block_decode.dtypes = collections.Counter()


def _count_encode(shape, dtype) -> None:
    """One ``codec_encode`` launch at ``shape`` from a ``dtype`` input."""
    with _count_lock:
        block_encode.launches += 1
        block_encode.shapes[shape] += 1
        block_encode.dtypes[dtype] += 1


def _count_decode(dtype) -> None:
    """One ``codec_decode`` launch into ``dtype``."""
    with _count_lock:
        block_decode.launches += 1
        block_decode.dtypes[dtype] += 1


def launch_counts() -> dict:
    with _count_lock:
        return {"codec_encode": block_encode.launches,
                "codec_decode": block_decode.launches}


def reset_launch_counts() -> None:
    with _count_lock:
        block_encode.launches = 0
        block_encode.shapes.clear()
        block_encode.dtypes.clear()
        block_decode.launches = 0
        block_decode.dtypes.clear()
