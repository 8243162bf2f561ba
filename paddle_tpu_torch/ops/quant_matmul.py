"""Int8 weight-only quantization and quantized matmul (reference:
``paddle_tpu/ops/quant_matmul.py`` ``quantize_int8``/``_quantize_kernel``,
``_hash_uniform``, ``stable_seed`` and ``quant_matmul``/``_qmm_kernel``).

Two kernels (the second in two forms), each with its plain PyTorch
version beside it:

  quantize_int8(w, stochastic, seed) -> (q int8 [k, n], scales fp32 [1, n])
  quant_matmul(x, qw, scales)        -> x @ (qw * scales), fp32 accumulator,
                                        in x's dtype (fp32, bf16 or fp16)
                                        or, for 16-bit x, fp32

Dispatch is by where the tensors lie, and nothing else: a CPU tensor takes
the plain version, a CUDA tensor the hand-written kernel
(``csrc/quant_matmul.cu``) or an error. There is no fallback from the
kernel to the plain version. Each wrapper counts its kernel launches in
``<wrapper>.launches`` (``launch_counts()``) and, by shape, in
``<wrapper>.shapes`` (``shape_counts()``: ``(k, n)`` for
``quantize_int8``, ``(m, k, n)`` for ``quant_matmul``), incremented only
where the kernel is launched; the 16-bit forms of ``quant_matmul`` by
x's dtype in ``quant_matmul.launches_bf16`` and ``.shapes_bf16`` (the key
``quant_matmul_bf16`` in both tables) and ``launches_fp16``,
``.shapes_fp16`` (``quant_matmul_fp16``), and by route in
``quant_matmul.routes_bf16``, ``.routes_fp16`` (``route_counts(dtype)``).

Numerics of ``quantize_int8`` are the reference's as XLA compiles it on
the CPU: ``scale = max(amax * float32(1/127), 1e-12)`` (the constant
division becomes a multiply by the reciprocal), ``q = rint(w / scale)``
with a true division by the scale tensor, half to even. The stochastic
noise is the reference's uint32 murmur3-finalizer hash of (flat index,
seed), done here in int64 and masked to 32 bits after every multiply.
So the int8 payloads and the scales are bit-identical to the reference's,
on the CPU and on the card.

``quant_matmul`` accumulates ``x @ qw`` in fp32 and scales each column
at the end, as ``_qmm_kernel`` does. The reference sends shapes its tiles
do not divide to a plain ``x @ (qw * scales)``, which scales first; the
two agree to fp32 rounding. The CUDA kernel runs on the tensor cores in
split TF32 (``x = x_big + x_small``, both TF32; int8 is exact in TF32, so
two products ``x_big @ q + x_small @ q``), within the fp32 bound that
``tests/torch_checks.py`` ``qmm_limit`` holds it to;
``quant_matmul_split_tf32`` is the plain model of that arithmetic. The
kernels take any ``m, n, k >= 1`` with fixed tiles (fp32 and the bf16
``mma.sync`` kernel: 128 x 128 x 32, 32 or 64 rows at m <= 64, where k is
split over slices added in a fixed order by a second kernel; the bf16
wgmma route: 192 rows by 128 columns, k-steps of 64; the bf16 cluster
route: 16, 32 or 64 columns by all m <= 64 rows, k split eight ways):
``block_m``, ``block_n`` and ``block_k`` stand in the reference's
signature and raise when given (the reference's tile choice and autotune
cache, ``ops/pallas/autotune.py``, are ROADMAP Queue A, "the rest":
kernel tuner).
On the card ``quantize_int8`` takes fp32 weights; ``quant_matmul`` takes
fp32 ``x`` (the split-TF32 kernel, fp32 out) or bf16 or fp16 ``x``
(amp's, the ``quant_matmul_16`` kernels: 16-bit tensor cores, which hold
int8 exactly and form every product exactly, fp32 accumulation, the
scaled sum rounded to x's dtype once, or stored as fp32 for
``out_dtype=torch.float32`` from the same accumulator, as the
reference's ``(acc * s).astype(out_dtype)``). It refuses float64 ``x``
and any other ``out_dtype`` (fp32 ``x`` writes fp32 only; a 16-bit ``x``
its own dtype or fp32); nothing is upcast to reach the fp32 kernel.
The 16-bit forms have three routes, picked by shape (``route16``), never
by failure:

- ``"cluster"`` for m <= 64 (the reference's ``_qmm_kernel``,
  ``paddle_tpu/ops/quant_matmul.py:110``, on 16-bit ``x``: every 16-bit
  launch of an int8 BERT forward at batch 1 x 64 tokens, the pooler and
  the NSP head at any batch), where the int8 weight's bytes and, under a cold L2, the latency of
  device memory bound it: one launch, no workspace. The k reduction is
  split over a thread-block cluster of 8 blocks along k for each tile of
  16-64 columns; each block issues every copy of its k slice of q and x
  at once (one round trip to device memory), multiplies q^T x^T on
  ``mma.sync`` (n on the 16-row side, m on the 8-wide side, so m = 1
  wastes 7/8 of a small product, not 31/32 of a large one), keeps its
  fp32 partial sums in shared memory, and the cluster adds them in rank
  order through distributed shared memory: deterministic, no atomics.
  The NSP head's q (2 bytes a row) is read as the contiguous bytes it
  is; k % 8 != 0, an x off the 16-byte grid and ragged n take element
  loads.
- ``"wgmma"`` for m > 64 where TMA describes both operands (n % 16 == 0,
  k % 8 == 0, x and qw 16-byte aligned): a TMA + ``mbarrier`` + ``wgmma``
  kernel that widens each stage of q once, in registers.
- ``"mma_sync"`` for the other m > 64 shapes (the NSP head's n = 2 at a
  large batch, ragged pitches, an x off the 16-byte grid): the
  ``mma.sync`` kernel with its k slices and workspace.

A route that fails raises.
``quantize_int8`` launches as thread-block clusters (8 blocks along k per
32-column tile, their column maxima exchanged through distributed shared
memory), so w is read from device memory once.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import zlib
from typing import Tuple

import torch

from ..framework.device import require_sm90
from ._build import load_library
from .tf32 import split_tf32

__all__ = ["KERNEL_SOURCE", "quantize_int8", "quantize_int8_plain",
           "quant_matmul", "quant_matmul_plain", "quant_matmul_split_tf32",
           "hash_uniform",
           "stable_seed", "route16", "launch_counts", "shape_counts",
           "route_counts", "reset_launch_counts"]

KERNEL_SOURCE = "paddle_tpu_torch/csrc/quant_matmul.cu"
_U32 = 0xFFFFFFFF
# x's dtype -> the suffix of its launch counters
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_fp16"}
# a 16-bit x's dtype -> the type word of the quant_matmul_16 entry points
_X16 = {torch.bfloat16: 0, torch.float16: 1}


def stable_seed(name: str, base: int = 0) -> int:
    """Process-stable seed for a named weight: crc32, not the salted
    builtin ``hash``, so every process derives the same stochastic
    rounding bits for the same parameter name."""
    return (int(base) + zlib.crc32(name.encode("utf-8"))) & 0x7FFF_FFFF


# ------------------------------------------------------------ plain versions
def hash_uniform(shape, seed: int, device=None) -> torch.Tensor:
    """fp32 uniforms in [0, 1) from the reference's ``_hash_uniform``: a
    murmur3 finalizer over (flat index, seed) in uint32 arithmetic, here
    in int64 with the low 32 bits kept after every multiply (they survive
    int64 wraparound)."""
    r, c = shape
    rows = torch.arange(r, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(c, dtype=torch.int64, device=device)[None, :]
    h = (rows * c + cols) & _U32
    h = ((h * 2654435761) & _U32) ^ (int(seed) & _U32)
    h = h ^ (h >> 16)
    h = (h * 0x85EB_CA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2_AE35) & _U32
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_int8_plain(w: torch.Tensor, stochastic: bool = False,
                        seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``quantize_int8``."""
    w = w.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=w.device)
    amax = w.abs().amax(0, keepdim=True)
    scale = torch.maximum(amax * torch.tensor(1.0 / 127.0, **f32),
                          torch.tensor(1e-12, **f32))
    scaled = w / scale
    if stochastic:
        u = hash_uniform(w.shape, int(seed) & 0x7FFF_FFFF, w.device)
        v = torch.floor(scaled + u)
    else:
        v = torch.round(scaled)
    return v.clamp(-127, 127).to(torch.int8), scale


def quant_matmul_plain(x: torch.Tensor, qw: torch.Tensor,
                       scales: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain version of ``quant_matmul``: accumulate, then scale."""
    out = (x.to(torch.float32) @ qw.to(torch.float32)) * scales.reshape(1, -1)
    return out.to(out_dtype or x.dtype)


def quant_matmul_split_tf32(x: torch.Tensor, qw: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """The kernel's operand rounding in plain PyTorch: ``x`` split into
    two TF32 parts, each multiplied by the exact int8 weight in fp32,
    summed, then scaled. It models the operands, not the tensor cores'
    order of accumulation."""
    big, small = split_tf32(x)
    q = qw.to(torch.float32)
    return ((small @ q) + (big @ q)) * scales.reshape(1, -1).float()


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib(device_index: int) -> ctypes.CDLL:
    require_sm90(torch.device("cuda", device_index))
    lib = load_library("quant_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quantize_int8.argtypes = [p, p, p, i, i, i, ctypes.c_uint, p]
    lib.quant_matmul.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.quant_matmul_16.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.quant_matmul_16_wgmma.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.quant_matmul_16_cluster.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.quant_matmul_splits.argtypes = [i, i, i]
    for fn in (lib.quantize_int8, lib.quant_matmul, lib.quant_matmul_16,
               lib.quant_matmul_16_wgmma, lib.quant_matmul_16_cluster,
               lib.quant_matmul_splits):
        fn.restype = ctypes.c_int
    return lib


def _on_card(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _operand(name: str, t: torch.Tensor, dev, dtype) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"the kernel takes {dtype} {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def quantize_int8(w: torch.Tensor, stochastic: bool = False, seed: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[k, n] float weights -> ([k, n] int8, [1, n] fp32 scales), per
    output column. Deterministic: the same (w, stochastic, seed) gives the
    same bits on the CPU, on the card and in the reference."""
    if w.dim() != 2:
        raise ValueError(f"quantize_int8 takes [k, n], got {tuple(w.shape)}")
    if not _on_card(w):
        return quantize_int8_plain(w, stochastic, seed)
    dev = w.device
    _operand("w", w, dev, torch.float32)
    k, n = w.shape
    q = torch.empty((k, n), dtype=torch.int8, device=dev)
    scales = torch.empty((1, n), dtype=torch.float32, device=dev)
    if not q.numel():
        raise ValueError(f"quantize_int8 needs k, n >= 1, got {(k, n)}")
    with torch.cuda.device(dev):
        rc = _lib(dev.index).quantize_int8(
            w.data_ptr(), q.data_ptr(), scales.data_ptr(), k, n,
            int(bool(stochastic)), int(seed) & 0x7FFF_FFFF, _stream(dev))
    if rc:
        raise RuntimeError(f"quantize_int8 launch failed: CUDA error {rc}")
    quantize_int8.launches += 1
    quantize_int8.shapes[(k, n)] += 1
    return q, scales


def route16(x: torch.Tensor, qw: torch.Tensor) -> str:
    """The kernel that takes 16-bit ``x [m, k] @ qw [k, n]`` on the card:
    "cluster" for m <= 64; "wgmma" for m > 64 where TMA describes both
    operands (row pitches and bases on the 16-byte grid), else
    "mma_sync"."""
    (m, k), n = x.shape, qw.shape[1]
    if m <= 64:
        return "cluster"
    if (n % 16 == 0 and k % 8 == 0 and x.data_ptr() % 16 == 0
            and qw.data_ptr() % 16 == 0):
        return "wgmma"
    return "mma_sync"


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                 block_m=None, block_n=None, block_k=None,
                 out_dtype=None) -> torch.Tensor:
    """``x [m, k] @ (qw [k, n] int8 * scales [1, n])`` -> ``[m, n]`` in
    ``out_dtype`` (default ``x.dtype``; fp32 ``x`` writes fp32 on the
    card, 16-bit ``x`` its dtype or fp32). The tiles are fixed: a block
    argument raises."""
    if (block_m, block_n, block_k) != (None, None, None):
        raise ValueError("quant_matmul's tiles are fixed (128 x 128 x 32, "
                         "32 or 64 rows at m <= 64; 16-bit x at m > 64: "
                         "192 x 128 x 64, at m <= 64: k split over a "
                         "cluster of 8); block_m/block_n/block_k are not "
                         "ported (ROADMAP Queue A, 'the rest': kernel "
                         "tuner)")
    if x.dim() != 2 or qw.dim() != 2 or x.shape[1] != qw.shape[0]:
        raise ValueError(f"quant_matmul takes x [m, k] and qw [k, n], got "
                         f"{tuple(x.shape)} and {tuple(qw.shape)}")
    if scales.numel() != qw.shape[1]:
        raise ValueError(f"scales has {scales.numel()} values for "
                         f"{qw.shape[1]} columns")
    if not _on_card(x):
        return quant_matmul_plain(x, qw, scales, out_dtype)
    dev = x.device
    sfx = _SUFFIX.get(x.dtype)
    if sfx is None:
        raise TypeError(f"the quant_matmul kernels take float32, bfloat16 "
                        f"or float16 x, got {x.dtype}")
    out_dtype = out_dtype or x.dtype
    out_f32 = bool(sfx) and out_dtype == torch.float32
    if out_dtype != x.dtype and not out_f32:
        raise TypeError(f"the kernel writes {x.dtype} x's product in "
                        f"{x.dtype}{' or float32' if sfx else ''}, not "
                        f"{out_dtype}")
    _operand("x", x, dev, x.dtype)
    _operand("qw", qw, dev, torch.int8)
    _operand("scales", scales, dev, torch.float32)
    if qw.data_ptr() % 4:
        raise ValueError("qw must be 4-byte aligned")
    (m, k), n = x.shape, qw.shape[1]
    if not (m and n and k):
        raise ValueError(f"quant_matmul needs m, n, k >= 1, got {(m, n, k)}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib = _lib(dev.index)
    route = route16(x, qw) if sfx else None
    words = (_X16[x.dtype], int(out_f32)) if sfx else ()
    with torch.cuda.device(dev):
        if route in ("wgmma", "cluster"):
            rc = getattr(lib, "quant_matmul_16_" + route)(
                x.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                out.data_ptr(), m, n, k, *words, _stream(dev))
        else:
            splits = lib.quant_matmul_splits(m, n, k)
            ws = (torch.empty((splits, m, n), dtype=torch.float32,
                              device=dev) if splits > 1 else None)
            rc = getattr(lib, "quant_matmul_16" if sfx else "quant_matmul")(
                x.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                out.data_ptr(), ws.data_ptr() if ws is not None else None,
                m, n, k, *words, _stream(dev))
    if rc:
        raise RuntimeError(f"quant_matmul{sfx} launch failed"
                           f"{f' ({route} route)' if route else ''}: CUDA "
                           f"error {rc}")
    setattr(quant_matmul, "launches" + sfx,
            getattr(quant_matmul, "launches" + sfx) + 1)
    getattr(quant_matmul, "shapes" + sfx)[(m, k, n)] += 1
    if route:
        getattr(quant_matmul, "routes" + sfx)[route] += 1
    return out


# name in the count tables -> (wrapper, suffix of its counters)
_COUNTERS = {"quantize_int8": (quantize_int8, ""),
             "quant_matmul": (quant_matmul, ""),
             "quant_matmul_bf16": (quant_matmul, "_bf16"),
             "quant_matmul_fp16": (quant_matmul, "_fp16")}


def launch_counts() -> dict:
    return {name: getattr(f, "launches" + sfx)
            for name, (f, sfx) in _COUNTERS.items()}


def shape_counts() -> dict:
    """Launches by shape since the last reset, per kernel."""
    return {name: collections.Counter(getattr(f, "shapes" + sfx))
            for name, (f, sfx) in _COUNTERS.items()}


def route_counts(dtype=torch.bfloat16) -> collections.Counter:
    """Launches of the 16-bit form on ``dtype`` x by route ("cluster",
    "wgmma", "mma_sync") since the last reset."""
    return collections.Counter(getattr(quant_matmul,
                                       "routes" + _SUFFIX[dtype]))


def reset_launch_counts() -> None:
    for f, sfx in _COUNTERS.values():
        setattr(f, "launches" + sfx, 0)
        setattr(f, "shapes" + sfx, collections.Counter())
    quant_matmul.routes_bf16 = collections.Counter()
    quant_matmul.routes_fp16 = collections.Counter()


reset_launch_counts()
