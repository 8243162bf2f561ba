"""Chunk epilogues of the fused linear + cross-entropy loss (reference:
the scan bodies of ``paddle_tpu/incubate/nn/functional.py``
``fused_linear_cross_entropy``, ``_fwd_state``'s step at :231-249 and
``_core_bwd``'s at :266-279, which the reference computes in jnp).

Two kernels over one fp32 chunk of logits ``[N, C]`` (columns ``start``
to ``start + C - 1`` of the vocabulary), each with its plain PyTorch
version beside it:

  ce_chunk_fwd  logit, bias_c, labels, start, V; m, s, picked in place:
                the chunk merged into the online logsumexp (running max
                ``m`` and sum ``s``) and the label's logit picked
  ce_chunk_bwd  logit, bias_c, lse, labels, g, start; logit in place:
                ``dlogit = (exp(logit - lse) - onehot) * g``

Dispatch is by where the tensors lie, and nothing else: a CPU tensor
takes the plain version, a CUDA tensor the hand-written kernel
(``csrc/fused_ce.cu``) or an error. There is no fallback from the kernel
to the plain version. Each wrapper counts its kernel launches in
``<wrapper>.launches`` and by ``(N, C)`` in ``<wrapper>.shapes``,
incremented only where the kernel is launched.

The chunk holds only columns below ``V``: the port's last chunk is
ragged (``V - start`` columns) where the reference pads the vocabulary
to the chunk grid and masks the padding to ``-inf``; ``exp(-inf)`` adds
nothing, so the sums are the same. The bias, when given, is the chunk's
fp32 slice, added to each logit as the reference adds it.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..framework.device import require_sm90
from ._build import load_library

__all__ = ["KERNEL_SOURCE", "ce_chunk_fwd", "ce_chunk_bwd",
           "ce_chunk_fwd_plain", "ce_chunk_bwd_plain", "launch_counts",
           "reset_launch_counts"]

KERNEL_SOURCE = "paddle_tpu_torch/csrc/fused_ce.cu"


# ------------------------------------------------------------ plain versions
def _with_bias(logit, bias):
    return logit if bias is None else logit + bias


def ce_chunk_fwd_plain(logit, bias, labels, start: int, m, s, picked):
    """Plain version of ``ce_chunk_fwd``: the reference's step, in place
    on ``m``, ``s`` and ``picked``."""
    x = _with_bias(logit, bias)
    c = x.shape[1]
    m_new = torch.maximum(m, x.amax(-1))
    s.copy_(s * torch.exp(m - m_new)
            + torch.exp(x - m_new[:, None]).sum(-1))
    in_chunk = (labels >= start) & (labels < start + c)
    idx = (labels.long() - start).clamp(0, c - 1)
    mine = x.gather(1, idx[:, None])[:, 0]
    picked.copy_(torch.where(in_chunk, mine, picked))
    m.copy_(m_new)


def ce_chunk_bwd_plain(logit, bias, lse, labels, g, start: int):
    """Plain version of ``ce_chunk_bwd``: ``(exp(x - lse) - onehot) * g``
    written over ``logit``."""
    x = _with_bias(logit, bias)
    col = torch.arange(x.shape[1], device=x.device) + start
    onehot = (labels.long()[:, None] == col[None, :]).to(torch.float32)
    logit.copy_((torch.exp(x - lse[:, None]) - onehot) * g[:, None])


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib(device_index: int) -> ctypes.CDLL:
    require_sm90(torch.device("cuda", device_index))
    lib = load_library("fused_ce")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ce_chunk_fwd.argtypes = [p, p, p, i64, i64, i64, p, p, p, p]
    lib.ce_chunk_fwd.restype = ctypes.c_int
    lib.ce_chunk_bwd.argtypes = [p, p, p, p, p, i64, i64, i64, p]
    lib.ce_chunk_bwd.restype = ctypes.c_int
    return lib


def _check(name: str, t, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_chunk(logit, bias, labels, rows):
    """Device, dtypes, shapes and contiguity of a chunk's operands; the
    chunk's ``(N, C)``."""
    if logit.dim() != 2:
        raise ValueError(f"logit must be [N, C], got {tuple(logit.shape)}")
    n, c = logit.shape
    dev = logit.device
    _check("logit", logit, torch.float32, (n, c), dev)
    if bias is not None:
        _check("bias", bias, torch.float32, (c,), dev)
    _check("labels", labels, torch.int32, (n,), dev)
    for name, t in rows.items():
        _check(name, t, torch.float32, (n,), dev)
    return n, c


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def ce_chunk_fwd(logit, bias, labels, start: int, vocab: int, m, s, picked):
    """Merge the chunk ``logit`` [N, C] (fp32, columns ``start`` ..
    ``start + C - 1`` of a vocabulary of ``vocab``) into the running
    ``m``, ``s`` and ``picked`` (fp32 [N], in place); ``labels`` int32
    [N], ``bias`` the chunk's fp32 [C] or None."""
    if not 0 <= start < start + logit.shape[-1] <= vocab:
        raise ValueError(f"chunk [{start}, {start + logit.shape[-1]}) is "
                         f"not inside the vocabulary of {vocab}")
    if logit.device.type == "cpu":
        return ce_chunk_fwd_plain(logit, bias, labels, start, m, s, picked)
    if logit.device.type != "cuda":
        raise ValueError(f"unsupported device {logit.device}")
    n, c = _check_chunk(logit, bias, labels, {"m": m, "s": s,
                                              "picked": picked})
    dev = logit.device
    lib = _lib(dev.index)
    with torch.cuda.device(dev):
        rc = lib.ce_chunk_fwd(logit.data_ptr(), _ptr(bias), labels.data_ptr(),
                              n, c, start, m.data_ptr(), s.data_ptr(),
                              picked.data_ptr(), _stream(dev))
    if rc:
        raise RuntimeError(f"ce_chunk_fwd launch failed: CUDA error {rc}")
    ce_chunk_fwd.launches += 1
    ce_chunk_fwd.shapes[(n, c)] += 1


def ce_chunk_bwd(logit, bias, lse, labels, g, start: int):
    """Overwrite the chunk ``logit`` [N, C] (fp32) with its gradient
    ``(exp(logit + bias - lse) - onehot(labels - start)) * g``; ``lse``
    and ``g`` fp32 [N], ``labels`` int32 [N]."""
    if logit.device.type == "cpu":
        return ce_chunk_bwd_plain(logit, bias, lse, labels, g, start)
    if logit.device.type != "cuda":
        raise ValueError(f"unsupported device {logit.device}")
    n, c = _check_chunk(logit, bias, labels, {"lse": lse, "g": g})
    dev = logit.device
    lib = _lib(dev.index)
    with torch.cuda.device(dev):
        rc = lib.ce_chunk_bwd(logit.data_ptr(), _ptr(bias), lse.data_ptr(),
                              labels.data_ptr(), g.data_ptr(), n, c, start,
                              _stream(dev))
    if rc:
        raise RuntimeError(f"ce_chunk_bwd launch failed: CUDA error {rc}")
    ce_chunk_bwd.launches += 1
    ce_chunk_bwd.shapes[(n, c)] += 1


ce_chunk_fwd.launches = 0
ce_chunk_fwd.shapes = collections.Counter()
ce_chunk_bwd.launches = 0
ce_chunk_bwd.shapes = collections.Counter()


def launch_counts() -> dict:
    return {"ce_chunk_fwd": ce_chunk_fwd.launches,
            "ce_chunk_bwd": ce_chunk_bwd.launches}


def reset_launch_counts() -> None:
    for fn in (ce_chunk_fwd, ce_chunk_bwd):
        fn.launches = 0
        fn.shapes.clear()
