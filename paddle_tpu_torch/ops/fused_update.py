"""Fused optimizer update over a flat bucket (reference:
``paddle_tpu/ops/pallas/fused_update.py`` ``FUSED_RULES``, ``rule_spec``,
``_update_math``, ``_scalar_prep``, ``fused_update_flat``,
``fused_dequant_update_flat`` (lines 134-154, 239-300) and
``reference_update_flat``).

``fused_update_buckets`` is the kernel wrapper the optimizer runs
(``csrc/fused_update.cu``): SGD, Momentum, Adam or AdamW over every flat
bucket of a :class:`BucketTable`, fp32 and bf16 buckets alike, in one
launch, **in place** on the parameters and moment slots (the reference
is functional and makes one call per bucket; the port updates in place
so a step allocates nothing). ``fused_update_flat``, the reference's
one-bucket signature, runs it on a table of one. Dispatch is by where
the tensors lie: a CPU tensor takes the plain version
(``buckets_plain``, ``_update_math`` in PyTorch, results copied back),
a CUDA tensor the kernel or an error.
``fused_update_buckets.launches`` counts the kernel's launches.

The plain version repeats the reference's op order exactly and divides
only by tensors: on the card PyTorch turns a division by a Python scalar
into a multiply by its reciprocal, which is a different rounding. The
kernel rounds every op as PyTorch does (no FMA contraction), so on the
card kernel and plain version agree bit for bit. Across frameworks XLA
may contract ``a*b+c`` on the CPU, so the port agrees with a compiled
JAX update to a few ulp (the reference's own contract).

A bf16 bucket (bf16 parameters and gradients, fp32 moments) follows the
reference's cast chain (``paddle_tpu/ops/pallas/fused_update.py:12-28``,
``optimizer/fused.py`` ``_bucket_fn``): the gradient is cast to the
parameters' dtype and lifted to fp32, the parameter lifted to fp32, the
rule runs in fp32, and the new parameter is rounded to bf16 to nearest
even. ``reference_update_flat`` is that chain for any dtype, and the
kernel equals it bit for bit.

Scalars stay on the device. ``fused_update_buckets`` computes each
bucket's ``lr*lm``, ``beta_pow*beta`` and ``1 - beta_pow*beta`` in the
kernel with ``scalar_prep``'s fp32 ops, from the device ``lr`` and the
table's beta powers, and writes the stepped powers to a second buffer
(the table alternates two, so no thread reads a power another thread
has stepped). A step never waits for the card.

``fused_dequant_update_buckets`` is the second kernel wrapper: the same
update over a table whose entries carry, in place of the gradient, the
gradient wire's summed payload (a :class:`WirePayload`: ``grad_comm``
``reduce_bucket_payload``'s int32 or fp32 carrier and one fp32 scale per
``block_size`` elements, and an optional residual), decoded inside the
kernel as ``q * scale / world (+ residual)`` and then put through the
reference's cast chain (rounded to the bucket's dtype, then to the
parameters', and lifted to fp32), so the decoded gradient never reaches
device memory. It runs once a step over every bucket, fp32 and bf16
alike, with the scalar prep on the card as in ``fused_update_buckets``.
Its plain version, ``reference_dequant_update_flat`` bucket by bucket,
follows the reference's ``_dequant_kernel`` op for op;
``fused_dequant_update_flat`` (the reference's one-bucket signature) is
the launch on a table of one. Unlike the reference, the port does not
fold the bucket into 128-lane rows: the kernel reads
``scale[i // block_size]`` itself, so every ``block_size`` runs it (the
reference falls back to a decode and the plain update when
``block_size % 128``). Launches are counted in total
(``fused_dequant_update_buckets.launches``) and the buckets they
updated by size and dtype (``fused_dequant_update_buckets.sizes``).
"""
from __future__ import annotations

import ctypes
import functools
import struct
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..framework.device import require_sm90
from ..framework.numeric import div_rn, n_scale_blocks, sqrt_rn
from ._build import load_library

__all__ = ["FUSED_RULES", "KERNEL_SOURCE", "rule_spec", "slot_names",
           "scalar_prep", "update_math", "fused_update_flat",
           "BucketTable", "fused_update_buckets", "buckets_plain",
           "reference_update_flat", "launch_counts",
           "reset_launch_counts", "dequant_grad", "WirePayload",
           "reference_dequant_update_flat", "fused_dequant_update_buckets",
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
    new_p = p - svec[0] * mhat / (sqrt_rn(vhat) + eps)
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
    lib.fused_update_buckets.argtypes = [p, i, ctypes.c_int64, p, i, f, f, f,
                                         f, f, i, p]
    lib.fused_update_buckets.restype = ctypes.c_int
    lib.fused_dequant_update_buckets.argtypes = [p, i, ctypes.c_int64, p, i,
                                                 f, i, f, f, f, f, f, i, p]
    lib.fused_dequant_update_buckets.restype = ctypes.c_int
    return lib


def _check_flat(name, t, n, dev, dtypes=(torch.float32,), aligned=True):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"fused_update takes {name} in "
                        f"{', '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != 1 or t.numel() != n:
        raise ValueError(f"{name} must be a flat [{n}] tensor, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or (aligned and t.data_ptr() % 16):
        raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                         f"for the kernel's vector loads")


def _check_rule(kind, slot_list):
    if kind not in _KIND_ID:
        raise ValueError(f"kind must be one of {tuple(_KIND_ID)}, got "
                         f"{kind!r}")
    if len(slot_list) != len(slot_names(kind)):
        raise ValueError(f"{kind} takes slots {slot_names(kind)}")


def _hyper_args(hyper):
    """The kernels' rule arguments: h0, h1, 1 - h0, 1 - h1, eps,
    nesterov (fp32 rounded on the host)."""
    h0 = hyper.get("momentum", hyper.get("beta1", 0.0))
    h1 = hyper.get("beta2", 0.0)
    return (h0, h1, 1 - h0, 1 - h1, hyper.get("eps", 0.0),
            int(bool(hyper.get("nesterov", False))))


# ------------------------------------------------------ multi-bucket table
# 8-byte words a bucket in the kernel's table (csrc/fused_update.cu
# Bucket): p, g, s0, s1, pow_in, pow_out, n, first chunk, (wd, lm) as two
# fp32 bit patterns, the dtype word; then the dequantizing update's q,
# scales, residual and block size (0 in a plain table)
TABLE_WORDS = 14
# a bucket's parameter dtype -> (the table's dtype word, elements a
# chunk: one 16-byte vector of parameters a thread)
BUCKET_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}
# the dtype word of fp32 parameters whose dequantized gradient is rounded
# to bf16 first (a bf16 bucket over fp32 parameters)
_BF16_GRAD_F32_P = 2
CARRIERS = (torch.int32, torch.float32)


class WirePayload(NamedTuple):
    """What a dequantizing table entry carries in place of its gradient:
    the bucket's gradient-wire payload summed over the ranks, ``q`` (an
    int32 or fp32 carrier, ``[n_blocks, block_size]`` or flat), its fp32
    ``scales`` (one a block), an optional fp32 ``residual`` added to the
    decoded gradient, and the bucket's ``dtype``, to which the decoded
    gradient is rounded before the parameters' dtype (None: the
    parameters')."""
    q: torch.Tensor
    scales: torch.Tensor
    residual: Optional[torch.Tensor] = None
    dtype: Optional[torch.dtype] = None


def _grad_pointers(g) -> tuple:
    if isinstance(g, WirePayload):
        return (g.q.data_ptr(), g.scales.data_ptr(),
                0 if g.residual is None else g.residual.data_ptr())
    return (g.data_ptr(),)


def _f32_pair(a: float, b: float) -> int:
    """Two Python floats rounded to fp32, packed little-endian into one
    int64 word (the table's ``wd``, ``lm``)."""
    return struct.unpack("<q", struct.pack("<ff", a, b))[0]


class BucketTable:
    """What ``fused_update_buckets`` walks: one entry per flat bucket
    ``(p, g, slot tensors in slot_names(kind) order, wd, lm)``, ``p`` and
    ``g`` fp32 or bf16 (of one dtype a bucket; buckets may differ), the
    slots fp32, the rule ``kind`` and ``hyper`` shared by all of them,
    and for Adam(W) the buckets' beta powers in two ``[B, 2]`` fp32
    buffers used in turn: a launch reads ``pows[parity]`` and writes
    ``pows[1 - parity]``.

    With ``block_size``, the table is what ``fused_dequant_update_buckets``
    walks: every entry's ``g`` is a :class:`WirePayload` (one carrier
    dtype in all of them), decoded with ``block_size`` elements a scale.

    ``words`` is the kernel's table, ``[2, B, TABLE_WORDS]`` int64 (one
    row per parity: its pow_in and pow_out pointers swap), packed once
    here; on the card it is copied to device memory once, through pinned
    memory, without a wait. ``key`` holds every data pointer: a caller
    whose tensors moved builds a new table."""

    def __init__(self, kind: str, hyper: dict, entries: Sequence[tuple],
                 block_size: Optional[int] = None):
        if kind not in _KIND_ID:
            raise ValueError(f"kind must be one of {tuple(_KIND_ID)}, got "
                             f"{kind!r}")
        if not entries:
            raise ValueError("a bucket table needs at least one bucket")
        self.kind, self.hyper = kind, dict(hyper)
        self.device = entries[0][0].device
        on_card = self.device.type == "cuda"
        if not on_card and self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.block_size = block_size
        self.dequant = block_size is not None
        if self.dequant and int(block_size) <= 0:
            raise ValueError(f"block_size must be positive, got "
                             f"{block_size}")
        self.entries = []
        for b, (p, g, arrs, wd, lm) in enumerate(entries):
            _check_rule(kind, arrs)
            n = p.numel()
            _check_flat(f"bucket {b} p", p, n, self.device,
                        tuple(BUCKET_DTYPES), aligned=on_card)
            if self.dequant:
                g = self._check_payload(b, g, n, on_card)
            else:
                _check_flat(f"bucket {b} g", g, n, self.device, (p.dtype,),
                            aligned=on_card)
            for name, t in zip(slot_names(kind), arrs):
                _check_flat(f"bucket {b} {name}", t, n, self.device,
                            aligned=on_card)
            self.entries.append((p, g, list(arrs), float(wd), float(lm)))
        if self.dequant:
            carriers = {e[1].q.dtype for e in self.entries}
            if len(carriers) > 1:
                raise TypeError(f"one carrier dtype a launch, got "
                                f"{sorted(map(str, carriers))}")
            self.carrier = carriers.pop()
        chunks = [-(-e[0].numel() // BUCKET_DTYPES[e[0].dtype][1])
                  for e in self.entries]
        self.starts = [sum(chunks[:b]) for b in range(len(chunks))]
        self.total_chunks = sum(chunks)
        self.adam = kind in ("adam", "adamw")
        self.pows = (torch.ones((2, len(self.entries), 2),
                                dtype=torch.float32, device=self.device)
                     if self.adam else None)
        self._pow_views = ([[(self.pows[q, b, 0], self.pows[q, b, 1])
                             for b in range(len(self.entries))]
                            for q in (0, 1)] if self.adam else None)
        self.parity = 0
        self.words = torch.stack([self._pack(q) for q in (0, 1)])
        self.device_words = (
            self.words.pin_memory().to(self.device, non_blocking=True)
            if on_card else self.words)
        self.key = self.pointers(self.entries)

    def _check_payload(self, b, g, n, on_card) -> WirePayload:
        """A dequantizing entry's payload, checked, its carrier flat."""
        if not isinstance(g, WirePayload):
            raise TypeError(f"bucket {b}: a dequantizing table takes a "
                            f"WirePayload, got {type(g).__name__}")
        if g.q.dtype not in CARRIERS:
            raise TypeError(f"bucket {b}: the carrier must be int32 or "
                            f"fp32, q is {g.q.dtype}")
        if g.dtype not in (None, *BUCKET_DTYPES):
            raise TypeError(f"bucket {b}: a bucket dtype of fp32 or bf16, "
                            f"got {g.dtype}")
        nb = n_scale_blocks(n, self.block_size)
        q = g.q.reshape(-1)
        _check_flat(f"bucket {b} q", q, nb * self.block_size, self.device,
                    CARRIERS, aligned=on_card)
        _check_flat(f"bucket {b} scales", g.scales.reshape(-1), nb,
                    self.device, aligned=False)
        if g.residual is not None:
            _check_flat(f"bucket {b} residual", g.residual, n, self.device,
                        aligned=on_card)
        return g._replace(q=q, scales=g.scales.reshape(-1))

    @staticmethod
    def pointers(entries) -> tuple:
        """Every data pointer of ``entries``, the table's identity."""
        return tuple((p.data_ptr(), *_grad_pointers(g),
                      *(s.data_ptr() for s in arrs))
                     for p, g, arrs, *_ in entries)

    def _dtype_word(self, p, g) -> int:
        word = BUCKET_DTYPES[p.dtype][0]
        if self.dequant and p.dtype == torch.float32 \
                and g.dtype == torch.bfloat16:
            return _BF16_GRAD_F32_P
        return word

    def _pack(self, parity: int) -> torch.Tensor:
        rows = []
        for b, (p, g, arrs, wd, lm) in enumerate(self.entries):
            slots = [s.data_ptr() for s in arrs] + [0] * (2 - len(arrs))
            pin = pout = 0
            if self.adam:
                pin = self.pows[parity, b].data_ptr()
                pout = self.pows[1 - parity, b].data_ptr()
            wire = ([*_grad_pointers(g), int(self.block_size)]
                    if self.dequant else [0, 0, 0, 0])
            rows.append([p.data_ptr(), 0 if self.dequant else g.data_ptr(),
                         *slots, pin, pout, p.numel(), self.starts[b],
                         _f32_pair(wd, lm), self._dtype_word(p, g), *wire])
        return torch.tensor(rows, dtype=torch.int64)

    def powers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each bucket's ``(beta1_pow, beta2_pow)``: 0-dim views of the
        buffer the next launch reads (Adam(W) only)."""
        return self._pow_views[self.parity]

    def load_powers(self, powers) -> None:
        """Set the powers the next launch reads from ``powers``, one
        ``(beta1_pow, beta2_pow)`` pair of 0-dim tensors a bucket (a
        device copy, no wait)."""
        src = torch.stack([torch.stack([a, b]) for a, b in powers])
        self.pows[self.parity].copy_(src.to(torch.float32))


def buckets_plain(table: BucketTable, lr, world: Optional[int] = None
                  ) -> None:
    """Plain version of ``fused_update_buckets`` (and, for a dequantizing
    table, of ``fused_dequant_update_buckets`` at ``world``): the table
    walked bucket by bucket through ``reference_update_flat`` or
    ``reference_dequant_update_flat`` (``scalar_prep``, then
    ``update_math``), results copied back in place; Adam's stepped powers
    into the buffer the launch would write."""
    names = slot_names(table.kind)
    for b, (p, g, arrs, wd, lm) in enumerate(table.entries):
        slots = dict(zip(names, arrs))
        if table.adam:
            slots["beta1_pow"], slots["beta2_pow"] = table.powers()[b]
        if table.dequant:
            new_p, new_s = reference_dequant_update_flat(
                p, g.q, g.scales, world, slots, lr, kind=table.kind,
                hyper=table.hyper, block_size=table.block_size,
                bucket_dtype=g.dtype, lm=lm, wd=wd, residual=g.residual)
        else:
            new_p, new_s = reference_update_flat(p, g, slots, lr,
                                                 kind=table.kind,
                                                 hyper=table.hyper, lm=lm,
                                                 wd=wd)
        p.copy_(new_p)
        for nm, s in zip(names, arrs):
            s.copy_(new_s[nm])
        if table.adam:
            table.pows[1 - table.parity, b, 0] = new_s["beta1_pow"]
            table.pows[1 - table.parity, b, 1] = new_s["beta2_pow"]
    table.parity = 1 - table.parity


def launch_counts() -> dict:
    return {"fused_update": fused_update_buckets.launches}


def reset_launch_counts() -> None:
    fused_update_buckets.launches = 0
    fused_dequant_update_buckets.launches = 0
    fused_dequant_update_buckets.sizes.clear()


def _check_lr(lr, dev):
    if lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(f"lr must be a float32 scalar on {dev}")


def fused_update_buckets(table: BucketTable, lr) -> None:
    """One update of ``table.kind`` over every bucket of ``table``, in
    place, then the table's parity flips (``table.powers()`` are then the
    stepped powers). ``lr``: 0-dim fp32 tensor on the table's device.
    One kernel launch on the card, the plain walk on the CPU."""
    if table.dequant:
        raise ValueError("a dequantizing table: fused_dequant_update_buckets")
    if table.device.type == "cpu":
        buckets_plain(table, lr)
        return
    dev = table.device
    _check_lr(lr, dev)
    with torch.cuda.device(dev):
        rc = _lib(dev.index).fused_update_buckets(
            table.device_words[table.parity].data_ptr(), len(table.entries),
            table.total_chunks, lr.data_ptr(), _KIND_ID[table.kind],
            *_hyper_args(table.hyper),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"fused_update_buckets launch failed: CUDA "
                           f"error {rc}")
    table.parity = 1 - table.parity
    fused_update_buckets.launches += 1


fused_update_buckets.launches = 0


def fused_dequant_update_buckets(table: BucketTable, lr, world: int) -> None:
    """``fused_update_buckets`` for a dequantizing table (built with
    ``block_size``): every bucket's gradient decoded from its summed
    payload, ``q * scale / world (+ residual)``, and put through the cast
    chain, then the update, in place; the parity flips. One kernel launch
    on the card, the plain walk on the CPU."""
    if not table.dequant:
        raise ValueError("a plain table: fused_update_buckets")
    if world <= 0:
        raise ValueError(f"world must be positive, got {world}")
    if table.device.type == "cpu":
        buckets_plain(table, lr, world)
        return
    dev = table.device
    _check_lr(lr, dev)
    with torch.cuda.device(dev):
        rc = _lib(dev.index).fused_dequant_update_buckets(
            table.device_words[table.parity].data_ptr(), len(table.entries),
            table.total_chunks, lr.data_ptr(),
            int(table.carrier == torch.float32), float(world),
            _KIND_ID[table.kind], *_hyper_args(table.hyper),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"fused_dequant_update_buckets launch failed: "
                           f"CUDA error {rc}")
    table.parity = 1 - table.parity
    fused_dequant_update_buckets.launches += 1
    for p, *_ in table.entries:
        fused_dequant_update_buckets.sizes[
            (p.numel(), str(p.dtype).replace("torch.", ""))] += 1


fused_dequant_update_buckets.launches = 0
fused_dequant_update_buckets.sizes = Counter()


def fused_update_flat(flat_p, flat_g, slots: Dict, lr, *, kind: str,
                      hyper: dict, lm: float = 1.0, wd: float = 0.0):
    """One fused update over a flat bucket (the reference's signature):
    ``fused_update_buckets`` on a table of one. Updates ``flat_p`` and the
    moment slots in place and returns ``(flat_p, new_slots)`` (moment
    slots the same tensors, beta powers stepped)."""
    arrs = [slots[nm] for nm in slot_names(kind)]
    table = BucketTable(kind, hyper,
                        [(flat_p, flat_g.to(flat_p.dtype), arrs, wd, lm)])
    if table.adam:
        table.load_powers([(slots["beta1_pow"], slots["beta2_pow"])])
    fused_update_buckets(table, lr)
    new_slots = dict(zip(slot_names(kind), arrs))
    if table.adam:
        new_slots["beta1_pow"], new_slots["beta2_pow"] = table.powers()[0]
    return flat_p, new_slots


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
    """The plain composition ``fused_dequant_update_buckets`` replaces,
    one bucket (functional): ``dequant_grad`` then ``update_math``.
    Returns ``(new_p, new_slots)``."""
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


def dequant_launch_counts() -> dict:
    """Launches of ``fused_dequant_update_buckets``, and the bucket
    updates they made by ``(size, dtype)``."""
    return {"fused_dequant_update": fused_dequant_update_buckets.launches,
            "sizes": dict(fused_dequant_update_buckets.sizes)}


def fused_dequant_update_flat(flat_p, q, scales, world: int, slots: Dict, lr,
                              *, kind: str, hyper: dict, block_size: int,
                              bucket_dtype=None, lm: float = 1.0,
                              wd: float = 0.0, residual=None):
    """Fused ``block_decode`` + update over a flat bucket (the reference's
    signature): ``fused_dequant_update_buckets`` on a table of one.
    ``flat_p`` is fp32 or bf16 and ``bucket_dtype`` (None: the
    parameters') fp32 or bf16. Updates ``flat_p`` and the moment slots
    in place and returns ``(flat_p, new_slots)`` (moment slots the same
    tensors, beta powers stepped)."""
    arrs = [slots[nm] for nm in slot_names(kind)]
    table = BucketTable(kind, hyper,
                        [(flat_p, WirePayload(q, scales, residual,
                                              bucket_dtype), arrs, wd, lm)],
                        block_size=block_size)
    if table.adam:
        table.load_powers([(slots["beta1_pow"], slots["beta2_pow"])])
    fused_dequant_update_buckets(table, lr, world)
    new_slots = dict(zip(slot_names(kind), arrs))
    if table.adam:
        new_slots["beta1_pow"], new_slots["beta2_pow"] = table.powers()[0]
    return flat_p, new_slots
