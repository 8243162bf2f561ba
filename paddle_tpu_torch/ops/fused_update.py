"""Fused optimizer update over a flat bucket (reference:
``paddle_tpu/ops/pallas/fused_update.py`` ``FUSED_RULES``, ``rule_spec``,
``_update_math``, ``_scalar_prep``, ``fused_update_flat``,
``fused_dequant_update_flat`` (lines 134-154, 239-300),
``reference_update_flat`` and ``bucket_update_fn``).

``fused_update`` is the kernel wrapper (``csrc/fused_update.cu``): SGD,
Momentum, Adam or AdamW over one flat fp32 bucket, **in place** on the
parameters and moment slots (the reference is functional; the port
updates in place so a step allocates nothing). Dispatch is by where the
tensors lie: a CPU tensor takes the plain version (``_update_math`` in
PyTorch, results copied back), a CUDA tensor the kernel or an error.
``fused_update.launches`` counts kernel launches.

The plain version repeats the reference's op order exactly and divides
only by tensors: on the card PyTorch turns a division by a Python scalar
into a multiply by its reciprocal, which is a different rounding. The
kernel rounds every op as PyTorch does (no FMA contraction), so on the
card kernel and plain version agree bit for bit. Across frameworks XLA
may contract ``a*b+c`` on the CPU, so the port agrees with a compiled
JAX update to a few ulp (the reference's own contract).

Scalars stay on the device: ``scalar_prep`` builds ``svec`` =
``[lr*lm, 1-beta1^t, 1-beta2^t]`` with tensor ops and the kernel reads
it through a pointer, so a step never waits for the card.

``fused_dequant_update`` is the second kernel wrapper: the same update
fed by the gradient wire's summed payload (``grad_comm``
``reduce_bucket_payload``: an int32 or fp32 carrier and one fp32 scale
per ``block_size`` elements), decoded inside the kernel as
``q * scale / world (+ residual)``, so the decoded gradient never
reaches device memory. Its plain version, ``reference_dequant_update_flat``,
follows the reference's ``_dequant_kernel`` op for op. Unlike the
reference, the port does not fold the bucket into 128-lane rows: the
kernel reads ``scale[i // block_size]`` itself, so every ``block_size``
runs it (the reference falls back to a decode and the plain update when
``block_size % 128``). Launches are counted in total
(``fused_dequant_update.launches``) and by bucket size
(``fused_dequant_update.sizes``).
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from ..framework.device import require_sm90
from ..framework.numeric import div_rn, n_scale_blocks
from ._build import load_library

__all__ = ["FUSED_RULES", "KERNEL_SOURCE", "rule_spec", "slot_names",
           "scalar_prep", "update_math", "fused_update", "fused_update_flat",
           "reference_update_flat", "bucket_update_fn", "launch_counts",
           "reset_launch_counts", "dequant_grad",
           "reference_dequant_update_flat", "fused_dequant_update",
           "fused_dequant_update_flat", "dequant_launch_counts"]

KERNEL_SOURCE = "paddle_tpu_torch/csrc/fused_update.cu"
# optimizer class name -> fused kernel rule kind
FUSED_RULES = {"SGD": "sgd", "Momentum": "momentum", "Adam": "adam",
               "AdamW": "adamw"}
_KIND_ID = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 3}


def rule_spec(optimizer) -> Optional[Tuple[str, dict]]:
    """(kind, hyper) when ``optimizer``'s rule has a fused form, else None."""
    kind = FUSED_RULES.get(type(optimizer).__name__)
    if kind is None:
        return None
    if kind == "sgd":
        return kind, {}
    if kind == "momentum":
        return kind, {"momentum": float(optimizer._momentum),
                      "nesterov": bool(optimizer._nesterov)}
    return kind, {"beta1": float(optimizer._beta1),
                  "beta2": float(optimizer._beta2),
                  "eps": float(optimizer._epsilon)}


def slot_names(kind: str) -> Tuple[str, ...]:
    if kind == "momentum":
        return ("velocity",)
    if kind in ("adam", "adamw"):
        return ("moment1", "moment2")
    return ()


def update_math(p, g, slot_vals, svec, *, kind, hyper, wd):
    """``_update_math`` in PyTorch, line for line (same expressions, same
    evaluation order). Returns (new_p, [new slots])."""
    if kind == "sgd":
        if wd:
            g = g + wd * p
        return p - svec[0] * g, []
    if kind == "momentum":
        mom = hyper["momentum"]
        if wd:
            g = g + wd * p
        v = mom * slot_vals[0] + g
        if hyper["nesterov"]:
            return p - svec[0] * (g + mom * v), [v]
        return p - svec[0] * v, [v]
    beta1, beta2, eps = hyper["beta1"], hyper["beta2"], hyper["eps"]
    if wd and kind == "adam":
        g = g + wd * p
    m1 = beta1 * slot_vals[0] + (1 - beta1) * g
    m2 = beta2 * slot_vals[1] + (1 - beta2) * g * g
    mhat = m1 / svec[1]
    vhat = m2 / svec[2]
    new_p = p - svec[0] * mhat / (torch.sqrt(vhat) + eps)
    if wd and kind == "adamw":
        new_p = new_p - svec[0] * wd * p
    return new_p, [m1, m2]


def scalar_prep(kind, hyper, slots, lr, lm):
    """``svec`` and the stepped scalar slots, with the reference's ops:
    ``lr*lm`` and, for adam, the beta powers and ``1 - beta_pow``. ``lr``
    is a 0-dim fp32 tensor on the bucket's device."""
    lr_lm = lr * lm
    if kind in ("adam", "adamw"):
        b1p = slots["beta1_pow"] * hyper["beta1"]
        b2p = slots["beta2_pow"] * hyper["beta2"]
        svec = torch.stack([lr_lm, 1 - b1p, 1 - b2p]).to(torch.float32)
        return svec, {"beta1_pow": b1p, "beta2_pow": b2p}
    return lr_lm.reshape(1).to(torch.float32), {}


def reference_update_flat(flat_p, flat_g, slots, lr, *, kind, hyper, lm=1.0,
                          wd=0.0):
    """The plain composition the kernel replaces (functional): returns
    ``(new_p, new_slots)``, the update rule's math on a flat bucket."""
    g = flat_g.to(flat_p.dtype).to(torch.float32)
    p32 = flat_p.to(torch.float32)
    svec, scalar_slots = scalar_prep(kind, hyper, slots, lr, lm)
    new_p, new_arrs = update_math(p32, g, [slots[nm] for nm in
                                           slot_names(kind)],
                                  svec, kind=kind, hyper=hyper, wd=wd)
    out = dict(zip(slot_names(kind), new_arrs))
    out.update(scalar_slots)
    return new_p.to(flat_p.dtype), out


# ------------------------------------------------------------------ kernel
@functools.lru_cache(maxsize=None)
def _lib(device_index: int) -> ctypes.CDLL:
    require_sm90(torch.device("cuda", device_index))
    lib = load_library("fused_update")
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.fused_update.argtypes = [p, p, p, p, p, ctypes.c_int64, i, f, f, f,
                                 f, f, f, i, p]
    lib.fused_update.restype = ctypes.c_int
    lib.fused_dequant_update.argtypes = [p, p, i, p, p, p, p, p,
                                         ctypes.c_int64, ctypes.c_int64, f,
                                         i, f, f, f, f, f, f, i, p]
    lib.fused_dequant_update.restype = ctypes.c_int
    return lib


def _check_flat(name, t, n, dev, fp32=True):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if fp32 and t.dtype != torch.float32:
        raise TypeError(f"fused_update takes float32, {name} is {t.dtype}")
    if t.dim() != 1 or t.numel() != n:
        raise ValueError(f"{name} must be a flat [{n}] tensor, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                         f"for the kernel's vector loads")


def _check_rule(kind, slot_list):
    if kind not in _KIND_ID:
        raise ValueError(f"kind must be one of {tuple(_KIND_ID)}, got "
                         f"{kind!r}")
    if len(slot_list) != len(slot_names(kind)):
        raise ValueError(f"{kind} takes slots {slot_names(kind)}")


def _check_svec(kind, svec, dev):
    want = 3 if kind in ("adam", "adamw") else 1
    if svec.device != dev or svec.dtype != torch.float32 \
            or svec.shape != (want,):
        raise ValueError(f"svec must be float32 [{want}] on {dev}")


def _hyper_args(kind, hyper, wd):
    """The kernels' scalar arguments after ``svec``'s pointer: wd, h0,
    h1, 1 - h0, 1 - h1, eps, nesterov (fp32 rounded on the host)."""
    h0 = hyper.get("momentum", hyper.get("beta1", 0.0))
    h1 = hyper.get("beta2", 0.0)
    return (float(wd), h0, h1, 1 - h0, 1 - h1, hyper.get("eps", 0.0),
            int(bool(hyper.get("nesterov", False))))


def _slot_ptrs(slot_list):
    return [s.data_ptr() for s in slot_list] + [None] * (2 - len(slot_list))


def fused_update(flat_p, flat_g, slot_list, svec, *, kind: str, hyper: dict,
                 wd: float = 0.0) -> None:
    """One update of ``kind`` over a flat bucket, in place on ``flat_p``
    and the slot tensors (``slot_names(kind)`` order); ``svec`` from
    ``scalar_prep``."""
    _check_rule(kind, slot_list)
    if flat_p.device.type == "cpu":
        new_p, new_slots = update_math(
            flat_p.to(torch.float32), flat_g.to(torch.float32),
            list(slot_list), svec, kind=kind, hyper=hyper, wd=wd)
        flat_p.copy_(new_p)
        for s, v in zip(slot_list, new_slots):
            s.copy_(v)
        return
    if flat_p.device.type != "cuda":
        raise ValueError(f"unsupported device {flat_p.device}")
    dev, n = flat_p.device, flat_p.numel()
    for name, t in (("p", flat_p), ("g", flat_g),
                    *zip(slot_names(kind), slot_list)):
        _check_flat(name, t, n, dev)
    _check_svec(kind, svec, dev)
    if not n:
        return
    ptrs = _slot_ptrs(slot_list)
    with torch.cuda.device(dev):
        rc = _lib(dev.index).fused_update(
            flat_p.data_ptr(), flat_g.data_ptr(), ptrs[0], ptrs[1],
            svec.data_ptr(), n, _KIND_ID[kind], *_hyper_args(kind, hyper, wd),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"fused_update launch failed: CUDA error {rc}")
    fused_update.launches += 1


fused_update.launches = 0


def launch_counts() -> dict:
    return {"fused_update": fused_update.launches}


def reset_launch_counts() -> None:
    fused_update.launches = 0
    fused_dequant_update.launches = 0
    fused_dequant_update.sizes.clear()


def fused_update_flat(flat_p, flat_g, slots: Dict, lr, *, kind: str,
                      hyper: dict, lm: float = 1.0, wd: float = 0.0):
    """One fused update over a flat bucket: ``scalar_prep`` then
    ``fused_update``. Updates ``flat_p`` and the moment slots in place and
    returns ``(flat_p, new_slots)`` (moment slots the same tensors, beta
    powers stepped)."""
    svec, scalar_slots = scalar_prep(kind, hyper, slots, lr, lm)
    arrs = [slots[nm] for nm in slot_names(kind)]
    fused_update(flat_p, flat_g.to(flat_p.dtype), arrs, svec, kind=kind,
                 hyper=hyper, wd=wd)
    new_slots = dict(zip(slot_names(kind), arrs))
    new_slots.update(scalar_slots)
    return flat_p, new_slots


def bucket_update_fn(optimizer, lm: float, wd: float):
    """``f(flat_p, flat_g, slots, lr) -> (flat_p, new_slots)`` running
    ``optimizer``'s rule through ``fused_update_flat``, or None when the
    rule has no fused form."""
    spec = rule_spec(optimizer)
    if spec is None:
        return None
    kind, hyper = spec

    def f(flat_p, flat_g, slots, lr):
        return fused_update_flat(flat_p, flat_g, slots, lr, kind=kind,
                                 hyper=hyper, lm=lm, wd=wd)

    return f


# ------------------------------------------------- dequantizing update
def dequant_grad(q, scales, world, block_size, n, residual=None,
                 bucket_dtype=None, param_dtype=torch.float32):
    """The gradient ``_dequant_kernel`` feeds its update, as a tensor:
    ``q * scale`` per block, ``/ world`` (a true division by a device
    tensor), ``+ residual``, then the bucket-dtype and parameter-dtype
    casts and the fp32 lift."""
    nb = n_scale_blocks(n, block_size)
    vals = (q.reshape(nb, block_size).to(torch.float32)
            * scales.to(torch.float32)[:, None]).reshape(-1)[:n]
    gdec = div_rn(vals, world)
    if residual is not None:
        gdec = gdec + residual
    return (gdec.to(bucket_dtype or param_dtype).to(param_dtype)
            .to(torch.float32))


def reference_dequant_update_flat(flat_p, q, scales, world, slots, lr, *,
                                  kind, hyper, block_size, bucket_dtype=None,
                                  lm=1.0, wd=0.0, residual=None):
    """The plain composition ``fused_dequant_update`` replaces
    (functional): ``dequant_grad`` then ``update_math``. Returns
    ``(new_p, new_slots)``."""
    n = flat_p.numel()
    g = dequant_grad(q, scales, world, block_size, n, residual, bucket_dtype,
                     flat_p.dtype)
    svec, scalar_slots = scalar_prep(kind, hyper, slots, lr, lm)
    new_p, new_arrs = update_math(flat_p.to(torch.float32), g,
                                  [slots[nm] for nm in slot_names(kind)],
                                  svec, kind=kind, hyper=hyper, wd=wd)
    out = dict(zip(slot_names(kind), new_arrs))
    out.update(scalar_slots)
    return new_p.to(flat_p.dtype), out


def fused_dequant_update(flat_p, q, scales, slot_list, svec, *, world: int,
                         block_size: int, kind: str, hyper: dict,
                         wd: float = 0.0, residual=None) -> None:
    """One update of ``kind`` over a flat bucket from the summed payload
    ``q`` (int32 or fp32 carrier, ``ceil(n / block_size) * block_size``
    elements) and its fp32 ``scales``, in place on ``flat_p`` and the slot
    tensors; ``svec`` from ``scalar_prep``."""
    _check_rule(kind, slot_list)
    n = flat_p.numel()
    if flat_p.device.type == "cpu":
        g = dequant_grad(q, scales, world, block_size, n, residual,
                         param_dtype=flat_p.dtype)
        new_p, new_slots = update_math(
            flat_p.to(torch.float32), g, list(slot_list), svec, kind=kind,
            hyper=hyper, wd=wd)
        flat_p.copy_(new_p)
        for s, v in zip(slot_list, new_slots):
            s.copy_(v)
        return
    if flat_p.device.type != "cuda":
        raise ValueError(f"unsupported device {flat_p.device}")
    dev = flat_p.device
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    nb = n_scale_blocks(n, block_size)
    for name, t in (("p", flat_p), *zip(slot_names(kind), slot_list)):
        _check_flat(name, t, n, dev)
    if residual is not None:
        _check_flat("residual", residual, n, dev)
    if q.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"fused_dequant_update takes an int32 or fp32 "
                        f"carrier, q is {q.dtype}")
    q = q.reshape(-1)
    _check_flat("q", q, nb * block_size, dev, fp32=False)
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    _check_flat("scales", scales.reshape(-1), nb, dev)
    _check_svec(kind, svec, dev)
    if not n:
        return
    ptrs = _slot_ptrs(slot_list)
    with torch.cuda.device(dev):
        rc = _lib(dev.index).fused_dequant_update(
            flat_p.data_ptr(), q.data_ptr(), int(q.dtype == torch.float32),
            scales.data_ptr(),
            None if residual is None else residual.data_ptr(),
            ptrs[0], ptrs[1], svec.data_ptr(), n, int(block_size),
            float(world), _KIND_ID[kind], *_hyper_args(kind, hyper, wd),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"fused_dequant_update launch failed: CUDA "
                           f"error {rc}")
    fused_dequant_update.launches += 1
    fused_dequant_update.sizes[n] += 1


fused_dequant_update.launches = 0
fused_dequant_update.sizes = Counter()


def dequant_launch_counts() -> dict:
    """Launches of ``fused_dequant_update``: total and by bucket size."""
    return {"fused_dequant_update": fused_dequant_update.launches,
            "sizes": dict(fused_dequant_update.sizes)}


def fused_dequant_update_flat(flat_p, q, scales, world: int, slots: Dict, lr,
                              *, kind: str, hyper: dict, block_size: int,
                              bucket_dtype=None, lm: float = 1.0,
                              wd: float = 0.0, residual=None):
    """Fused ``block_decode`` + update over a flat bucket (the reference's
    signature): ``scalar_prep`` then ``fused_dequant_update``. Updates
    ``flat_p`` and the moment slots in place and returns ``(flat_p,
    new_slots)``. ``bucket_dtype`` must be the parameters' dtype (fp32;
    the bf16 cast chain comes with ROADMAP Queue A 3)."""
    if bucket_dtype is not None and bucket_dtype != flat_p.dtype:
        raise NotImplementedError(
            f"bucket dtype {bucket_dtype} over {flat_p.dtype} parameters is "
            f"not ported yet (ROADMAP Queue A 3, bf16 training)")
    svec, scalar_slots = scalar_prep(kind, hyper, slots, lr, lm)
    arrs = [slots[nm] for nm in slot_names(kind)]
    fused_dequant_update(flat_p, q, scales, arrs, svec, world=world,
                         block_size=block_size, kind=kind, hyper=hyper,
                         wd=wd, residual=residual)
    new_slots = dict(zip(slot_names(kind), arrs))
    new_slots.update(scalar_slots)
    return flat_p, new_slots
