"""Flash attention forward and backward (reference:
``paddle_tpu/ops/flash_attention.py`` ``_fwd``/``_fwd_kernel``,
``_bwd``/``_dq_kernel``/``_dkv_kernel``, the ``_flash_bnsd`` custom VJP,
``flash_attention_val`` and ``flash_attention_supported``).

Three kernels over a ``[b, n, s, d]`` layout, each with its plain
PyTorch version beside it:

  flash_fwd  q, k, v          -> out [b,n,s,d], lse [b,n,s,1] fp32
  flash_dq   q, k, v, dO, lse, delta -> dq
  flash_dkv  q, k, v, dO, lse, delta -> dk, dv

Dispatch is by where the tensors lie, and nothing else: a CPU tensor
takes the plain version, a CUDA tensor the hand-written kernel
(``csrc/flash_attention.cu``) or an error. There is no fallback from the
kernel to the plain version. On the card the dtype picks the kernel:
fp32 or bf16 (``<name>_bf16`` in the source), each its own entry point.
Each wrapper counts its kernel launches in ``<wrapper>.launches`` (fp32)
and ``<wrapper>.launches_bf16`` (``launch_counts()``), incremented only
where the kernel is launched.

Numerics are the reference's: ``q`` pre-scaled by ``1/sqrt(d)``, masked
scores set to ``NEG_INF = -1e30``, ``l`` clamped at ``1e-30``, ``dq``
scaled at the end while ``dk`` carries the scale through the pre-scaled
``q``, and ``delta = rowsum(dO * O)`` computed outside the kernels. The
plain versions compute whole ``[s, s]`` score matrices; the kernels
stream 64-row tiles with an online softmax, so the two agree to fp32
rounding, not bit for bit. All three fp32 kernels run every product on
the tensor cores in 3xTF32 (each fp32 operand split into two TF32 parts,
three products); ``flash_fwd_split_tf32`` and ``flash_bwd_split_tf32``
are the plain models of that operand rounding, for the tests.

bf16 inputs (the reference's kernels take the parameters' dtype) give
bf16 ``out``, ``dq``, ``dk`` and ``dv``, fp32 ``lse`` and ``delta``; the
plain versions compute in fp32 and cast the outputs, the reference's
order, and the bf16 kernels multiply on bf16 tensor cores with fp32
accumulators, rounding ``p`` and ``ds`` to bf16 where they are an
operand (the source says why that holds the tolerance). The three bf16
kernels load their tiles by TMA and multiply on ``wgmma``
(``csrc/hopper.cuh``); the wrappers are the same for all.

The kernels take fp32 or bf16 (q, k, v and dO of one dtype), any
``s >= 1`` and ``d <= 128`` with ``d % 16 == 0`` (every GPT preset: 16,
64, 96, 128), and 16-byte aligned q, k, v and dO (as ``torch.empty``
gives them); anything else on the card raises. The reference's block
sizes have no counterpart: the CUDA tiles are fixed and the tail tile
is masked.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from ..framework.device import require_sm90
from ._build import load_library
from .tf32 import split_tf32, split_tf32_trunc, tf32_rna

__all__ = ["NEG_INF", "KERNEL_SOURCE", "flash_fwd", "flash_dq", "flash_dkv",
           "flash_fwd_plain", "flash_fwd_split_tf32", "flash_dq_plain",
           "flash_dkv_plain", "flash_bwd_plain", "flash_bwd_split_tf32",
           "flash_attention_val", "flash_attention_supported",
           "kernel_supported", "launch_counts", "reset_launch_counts"]

KERNEL_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
NEG_INF = -1e30
_MAX_D = 128


# ------------------------------------------------------------ plain versions
def _masked(s: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scores with the causal upper triangle set to ``NEG_INF`` (reference
    ``_causal_mask``)."""
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Masked ``(q * scale) . k^T`` [b, n, s, s] in fp32 (reference:
    ``_fwd_kernel`` :134-141 and ``_causal_mask``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _masked((q.float() * scale) @ k.float().transpose(-1, -2), causal)


def flash_fwd_plain(q, k, v, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_fwd``: (out [b,n,s,d], lse [b,n,s,1])."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (p @ v.float()) / l
    return out.to(q.dtype), m + torch.log(l)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor,
               split=split_tf32) -> torch.Tensor:
    """``a @ b`` from split operands: small.big + big.small + big.big."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` from operands rounded to TF32, one product."""
    return tf32_rna(a) @ tf32_rna(b)


def flash_fwd_split_tf32(q, k, v, causal: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_fwd_plain`` with both products in 3xTF32, as the kernel
    computes them: the scaled q, k, the unnormalised p and v each split
    into two TF32 parts. It models the operands' rounding, not the tensor
    cores' order of accumulation, and takes the softmax over whole rows
    where the kernel rescales tile by tile."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked(_mm_3xtf32(q.float() * scale, k.float().transpose(-1, -2)),
                causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = _mm_3xtf32(p, v.float()) / l
    return out.to(q.dtype), m + torch.log(l)


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Plain version of ``flash_dq`` (reference ``_dq_kernel``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta)
    return ((ds @ k.float()) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_dkv`` (reference ``_dkv_kernel``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse)
    dv = p.transpose(-1, -2) @ do.float()
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta)
    dk = ds.transpose(-1, -2) @ (q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, do, lse, delta, causal: bool):
    """(dq, dk, dv) from the plain versions of both backward kernels."""
    return (flash_dq_plain(q, k, v, do, lse, delta, causal),
            *flash_dkv_plain(q, k, v, do, lse, delta, causal))


def flash_bwd_split_tf32(q, k, v, do, lse, delta, causal: bool,
                         passes: int = 3):
    """(dq, dk, dv) of ``flash_bwd_plain`` with every product in 3xTF32,
    as ``flash_dq`` and ``flash_dkv`` compute them: the scaled q, k, dO,
    v, p and ds each split into two TF32 parts by ``split_tf32_trunc``
    (dkv's transposed scores hold the same split products). Like
    ``flash_fwd_split_tf32`` it models the operands' rounding, not the
    tensor cores' order of accumulation. ``passes=1`` rounds each operand
    to TF32 and multiplies once: a kernel that drops the small parts, for
    the tests' control."""
    if passes not in (1, 3):
        raise ValueError(f"passes is 3 (the kernels) or 1, got {passes}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    mm = (functools.partial(_mm_3xtf32, split=split_tf32_trunc)
          if passes == 3 else _mm_1xtf32)
    qs, kf, vf, dof = q.float() * scale, k.float(), v.float(), do.float()
    p = torch.exp(_masked(mm(qs, kf.transpose(-1, -2)), causal) - lse)
    ds = p * (mm(dof, vf.transpose(-1, -2)) - delta)
    dq = mm(ds, kf) * scale
    dk = mm(ds.transpose(-1, -2), qs)
    dv = mm(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib(device_index: int) -> ctypes.CDLL:
    require_sm90(torch.device("cuda", device_index))
    lib = load_library("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for sfx in ("", "_bf16"):
        getattr(lib, "flash_fwd" + sfx).argtypes = [p, p, p, p, p, i, i, i,
                                                    i, f, p]
        getattr(lib, "flash_dq" + sfx).argtypes = [p, p, p, p, p, p, p, i, i,
                                                   i, i, f, p]
        getattr(lib, "flash_dkv" + sfx).argtypes = [p, p, p, p, p, p, p, p,
                                                    i, i, i, i, f, p]
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            getattr(lib, name + sfx).restype = ctypes.c_int
    return lib


# kernel input dtype -> the C entry points' suffix
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def kernel_supported(shape) -> bool:
    """True if the CUDA kernels take a ``[b, n, s, d]`` shape."""
    if len(shape) != 4:
        return False
    b, n, s, d = (int(x) for x in shape)
    return b >= 1 and n >= 1 and s >= 1 and 16 <= d <= _MAX_D and d % 16 == 0


def _check(names, tensors, shape, n_fp32=0):
    """Device, dtype, shape and layout the kernels take; returns the
    device. The last ``n_fp32`` tensors (lse, delta) are fp32, the others
    share one of the kernels' dtypes. Raises on anything else."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if not kernel_supported(shape):
        raise ValueError(f"flash attention kernels take [b, n, s, d] with "
                         f"s >= 1 and d <= {_MAX_D}, d % 16 == 0; got "
                         f"{tuple(shape)}")
    if dt not in _SUFFIX:
        raise TypeError(f"flash attention kernels take float32 or "
                        f"bfloat16, {names[0]} is {dt} (other dtypes are not "
                        f"ported yet: ROADMAP Queue A, 'other dtypes')")
    for i, (name, t) in enumerate(zip(names, tensors)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        want = torch.float32 if i >= len(names) - n_fp32 else dt
        if t.dtype != want:
            raise TypeError(f"flash attention kernels take {name} in "
                            f"{want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _dispatch(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def flash_fwd(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward on ``[b, n, s, d]`` -> (out, lse [b,n,s,1])."""
    if not _dispatch(q):
        return flash_fwd_plain(q, k, v, causal)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    dev = _check(("q", "k", "v"), (q, k, v), q.shape)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd takes 16-byte aligned q, k and v")
    b, n, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, n, s, 1), dtype=torch.float32, device=dev)
    sfx = _SUFFIX[q.dtype]
    with torch.cuda.device(dev):
        rc = getattr(_lib(dev.index), "flash_fwd" + sfx)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * n, s, d, int(bool(causal)),
            1.0 / math.sqrt(d), _stream(dev))
    if rc:
        raise RuntimeError(f"flash_fwd{sfx} launch failed: CUDA error {rc}")
    _count(flash_fwd, sfx)
    return out, lse


def _bwd_operands(q, k, v, do, lse, delta):
    if any(t.shape != q.shape for t in (k, v, do)):
        raise ValueError("q, k, v, dO shapes differ")
    rows = (*q.shape[:3], 1)
    if lse.shape != rows or delta.shape != rows:
        raise ValueError(f"lse and delta must be {rows}, got "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)}")
    dev = _check(("q", "k", "v", "dO", "lse", "delta"),
                 (q, k, v, do, lse, delta), q.shape, n_fp32=2)
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_dq and flash_dkv take 16-byte aligned q, k, "
                         "v and dO")
    return dev


def flash_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """dQ of attention on ``[b, n, s, d]`` from lse and delta."""
    if not _dispatch(q):
        return flash_dq_plain(q, k, v, do, lse, delta, causal)
    dev = _bwd_operands(q, k, v, do, lse, delta)
    b, n, s, d = q.shape
    dq = torch.empty_like(q)
    sfx = _SUFFIX[q.dtype]
    with torch.cuda.device(dev):
        rc = getattr(_lib(dev.index), "flash_dq" + sfx)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * n, s, d,
            int(bool(causal)), 1.0 / math.sqrt(d), _stream(dev))
    if rc:
        raise RuntimeError(f"flash_dq{sfx} launch failed: CUDA error {rc}")
    _count(flash_dq, sfx)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of attention on ``[b, n, s, d]`` from lse and delta."""
    if not _dispatch(q):
        return flash_dkv_plain(q, k, v, do, lse, delta, causal)
    dev = _bwd_operands(q, k, v, do, lse, delta)
    b, n, s, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    sfx = _SUFFIX[q.dtype]
    with torch.cuda.device(dev):
        rc = getattr(_lib(dev.index), "flash_dkv" + sfx)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * n, s, d, int(bool(causal)), 1.0 / math.sqrt(d),
            _stream(dev))
    if rc:
        raise RuntimeError(f"flash_dkv{sfx} launch failed: CUDA error {rc}")
    _count(flash_dkv, sfx)
    return dk, dv


_WRAPPERS = (flash_fwd, flash_dq, flash_dkv)


def _count(wrapper, sfx: str) -> None:
    name = "launches" + sfx
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def launch_counts() -> dict:
    """Kernel launches since the last reset: ``flash_fwd`` etc. for the
    fp32 kernels, ``flash_fwd_bf16`` etc. for the bf16 ones."""
    return {w.__name__ + sfx: getattr(w, "launches" + sfx)
            for sfx in _SUFFIX.values() for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        for sfx in _SUFFIX.values():
            setattr(w, "launches" + sfx, 0)


reset_launch_counts()


# -------------------------------------------------------------- autograd
class _FlashBNSD(torch.autograd.Function):
    """The reference's ``_flash_bnsd`` custom VJP on ``[b, n, s, d]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention_supported(q_shape) -> bool:
    """True if ``flash_attention_val`` takes this ``[b, s, n, d]`` shape on
    the card (the CPU's plain version takes any 4-D shape)."""
    if len(q_shape) != 4:
        return False
    b, s, n, d = q_shape
    return kernel_supported((b, n, s, d))


def flash_attention_val(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention on ``[b, s, n, d]`` tensors -> ``[b, s, n, d]``,
    differentiable through the flash backward."""
    if q.dim() != 4:
        raise ValueError(f"flash attention takes [b, s, n, d], got "
                         f"{tuple(q.shape)}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return _FlashBNSD.apply(qt, kt, vt, bool(causal)).transpose(1, 2)
