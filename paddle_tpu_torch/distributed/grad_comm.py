"""Gradient wire codecs, the bucket plan and the bucketed communicator
(reference: ``paddle_tpu/distributed/grad_comm.py`` ``CODECS``,
``EF_CODECS``, ``_WIRE_ITEMSIZE``, ``_QMAX``, ``GradCommConfig``,
``GradBucket``, ``build_buckets``, the bf16/int8/blockwise codecs,
``scale_bytes``, ``_block_kernel_ops``, ``record_sync_metrics`` and
``GradCommunicator``, lines 86-178, 260-357 and 447-800).

Blockwise codecs: one fp32 abs-max scale per ``block_size`` elements;
``int8_block`` rounds half-to-even and clips to +-127, ``fp8_block``
casts to float8_e4m3fn. The functions here are the plain versions of the
CUDA kernels in ``csrc/codec.cu`` (``ops/codec.py`` dispatches between
the two) and match the reference's payload bits.

Two forms of the payload. The KV cache stores it at rest, so
``block_encode`` returns the wire dtype itself (int8 or float8_e4m3fn)
by default. The gradient wire sums payloads over ranks, so with
``carrier=True`` it returns the reference's carrier: int8 values in
int32, fp8 values in fp32, which the sum neither wraps nor rounds.
``block_decode`` takes either.

``GradCommunicator`` reduces flat buckets over ``torch.distributed``
(``distributed/collective.py``): one collective per bucket for fp32 and
bf16, two for int8 (a scalar MAX of the scale, then the payload sum) and
for the blockwise codecs (the sum of the per-block abs-max, then the
payload sum). Encode and decode of the blockwise codecs go through the
codec wrappers, so on the card they run the CUDA kernels. The
error-feedback residual (what quantization dropped locally) is per rank
and carried across calls in ``_residuals``. ``reduce_bucket_payload``
stops at the summed payload, which the fused dequantize-and-update
kernel (``ops/fused_update.py``) consumes without decoding it to memory;
the payload and its scales live in buffers the communicator keeps per
bucket (``_wire``), so a consumer's pointers hold from step to step.

bf16 buckets ride the blockwise codecs as the reference's do: a bf16
flat is encoded where it lies (the kernel lifts it to fp32, exactly, as
the reference's ``_as_blocks`` does), unless error feedback adds the
fp32 residual first, which makes the sum fp32; the residual is fp32;
the decode rounds the fp32 ``q * scale / world`` once to the bucket's
dtype.

fp8 range: ``scales = absmax / 448`` keeps ``|x / s| <= 448 * (1 + ulp)``,
which rounds to 448, so the cast never sees an out-of-range value
(where torch saturates and ml_dtypes gives NaN, the two would differ).

Not ported yet (ROADMAP Queue A 2, the ZeRO remainder):
``use_reduce_scatter=True``, ``traced_reduce_scatter_quantized``,
``config_from_strategy``, ``comm_plan`` and the overlapped communicator.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# the collective module is bound by name, not function, so a test can
# replace ``collective.all_reduce`` and be seen here
from . import collective as _coll
from .collective import ReduceOp
from ..framework.numeric import div_rn, n_scale_blocks
from ..observability.metrics import get_registry as _get_registry

__all__ = ["CODECS", "BLOCK_CODECS", "EF_CODECS", "QMAX", "WIRE_DTYPE",
           "GradCommConfig", "GradBucket", "GradCommunicator",
           "build_buckets", "record_sync_metrics", "n_scale_blocks",
           "scale_bytes", "as_blocks", "block_absmax", "block_scales",
           "block_encode", "block_decode", "block_residual", "encode_bf16",
           "decode_bf16", "int8_scale", "int8_encode", "int8_decode",
           "int8_residual"]

_m_syncs = _get_registry().counter(
    "grad_comm_syncs_total", help="gradient sync rounds")
_m_coll = _get_registry().counter(
    "grad_comm_collectives_total",
    help="collectives issued by bucketed grad sync",
    labels=("codec", "path"))
_m_bytes = _get_registry().counter(
    "grad_comm_bytes_total", help="wire bytes moved by grad sync",
    labels=("codec", "path"))
_m_fill = _get_registry().histogram(
    "grad_comm_bucket_fill_ratio",
    help="bucket bytes / bucket cap at sync time",
    buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.5))

CODECS = ("fp32", "bf16", "int8", "int8_block", "fp8_block")
BLOCK_CODECS = ("int8_block", "fp8_block")
# codecs that carry a cross-step error-feedback residual
EF_CODECS = ("int8",) + BLOCK_CODECS
# wire bytes per gradient element (the scales are counted apart)
_WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1, "int8_block": 1,
                  "fp8_block": 1}
# largest representable magnitude of the wire format
QMAX = {"int8_block": 127.0, "fp8_block": 448.0}
WIRE_DTYPE = {"int8_block": torch.int8, "fp8_block": torch.float8_e4m3fn}
CARRIER_DTYPE = {"int8_block": torch.int32, "fp8_block": torch.float32}

_MB = 1024 * 1024


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, numpy's name, which the
    reference writes into bucket keys and layouts."""
    return str(dtype).replace("torch.", "")


class GradCommConfig:
    """Gradient-communication knobs: ``codec`` (one of ``CODECS``),
    ``comm_buffer_size`` and ``last_comm_buffer_size`` (bucket caps in
    MB), ``error_feedback`` (carry the quantization residual across
    steps; int8 and the blockwise codecs), ``overlap`` (the overlapped
    communicator: not ported yet, so only False) and ``block_size``
    (elements per abs-max scale of the blockwise codecs). Validation and
    messages are the reference's."""

    def __init__(self, codec: str = "bf16", comm_buffer_size: float = 25,
                 last_comm_buffer_size: float = 1, error_feedback: bool = True,
                 overlap: bool = False, block_size: int = 1024):
        if codec not in CODECS:
            raise ValueError(
                f"unknown grad_comm codec {codec!r}; one of {CODECS}")
        for name, v in (("comm_buffer_size", comm_buffer_size),
                        ("last_comm_buffer_size", last_comm_buffer_size)):
            try:
                ok = float(v) > 0
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"{name} must be a positive number of MB, got {v!r}")
        if not isinstance(block_size, (int, np.integer)) or block_size <= 0:
            raise ValueError(
                f"block_size must be a positive int, got {block_size!r}")
        if overlap:
            raise NotImplementedError(
                "GradCommConfig(overlap=True): the overlapped communicator "
                "is not ported yet (ROADMAP Queue A 2)")
        self.codec = codec
        self.comm_buffer_size = float(comm_buffer_size)
        self.last_comm_buffer_size = float(last_comm_buffer_size)
        self.error_feedback = bool(error_feedback)
        self.overlap = bool(overlap)
        self.block_size = int(block_size)

    def __repr__(self):
        return (f"GradCommConfig(codec={self.codec!r}, "
                f"comm_buffer_size={self.comm_buffer_size}, "
                f"last_comm_buffer_size={self.last_comm_buffer_size}, "
                f"error_feedback={self.error_feedback}, "
                f"overlap={self.overlap}, block_size={self.block_size})")


# ------------------------------------------------------------------ codecs
def encode_bf16(flat: torch.Tensor) -> torch.Tensor:
    return flat.to(torch.bfloat16)


def decode_bf16(wire: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return wire.to(dtype)


def int8_scale(flat: torch.Tensor) -> torch.Tensor:
    """Per-bucket abs-max scale: one fp32 scalar."""
    return div_rn(flat.abs().max().clamp_min(1e-12).to(torch.float32), 127.0)


def int8_encode(flat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize with the shared scale -> int8 values in an int32 carrier."""
    q = torch.round(flat.to(torch.float32) / scale).clamp_(-127, 127)
    return q.to(torch.int8).to(torch.int32)


def int8_decode(q_sum: torch.Tensor, scale: torch.Tensor, world: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Dequantize the summed payload, averaged over ``world``."""
    return div_rn(q_sum.to(torch.float32) * scale, world).to(dtype)


def int8_residual(flat, q, scale) -> torch.Tensor:
    """Error-feedback residual: what quantization dropped locally."""
    return flat.to(torch.float32) - q.to(torch.float32) * scale


def scale_bytes(numel: int, block_size: int) -> int:
    """Wire overhead of the per-block fp32 scale vector, in bytes."""
    return 4 * n_scale_blocks(numel, block_size)


def as_blocks(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n_blocks, block_size) fp32 view of a flat buffer, zero-padded."""
    flat = flat.reshape(-1).to(torch.float32)
    pad = n_scale_blocks(flat.numel(), block_size) * block_size - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block_size)


def block_absmax(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block abs-max (fp32 vector of n_blocks entries). A ragged tail
    is reduced on its own, with no padded copy of the buffer: |x| >= 0,
    so its max equals the zero-padded block's, bit for bit. A bf16 (or
    fp32) buffer is reduced in its own dtype and the maxima lifted: a
    max is exact in any dtype, so the bits are those of the reference's
    fp32 reduction, without an fp32 copy of the buffer."""
    flat = flat.reshape(-1)
    whole = flat.numel() // block_size * block_size
    absmax = flat[:whole].view(-1, block_size).abs().amax(dim=1)
    if whole != flat.numel():
        absmax = torch.cat([absmax, flat[whole:].abs().amax().reshape(1)])
    return absmax.to(torch.float32)


def block_scales(absmax: torch.Tensor, codec: str) -> torch.Tensor:
    """Quantization step per block from the (summed-over-ranks) abs-max."""
    return div_rn(absmax.to(torch.float32).clamp_min(1e-12), QMAX[codec])


def block_encode(flat: torch.Tensor, scales: torch.Tensor, block_size: int,
                 codec: str, carrier: bool = False,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blockwise quantize with ``scales`` -> [n_blocks, bs] in the wire
    dtype, or with ``carrier=True`` in the summable carrier (int32 for
    int8_block, fp32 for fp8_block); ``flat`` is lifted to fp32 first
    (exact from bf16). With ``out``, the same bits are copied into it and
    it is returned."""
    q = as_blocks(flat, block_size) / scales[:, None]
    if codec == "int8_block":
        q = torch.round(q).clamp_(-127, 127).to(torch.int8)
    else:
        q = q.to(torch.float8_e4m3fn)
    q = q.to(CARRIER_DTYPE[codec]) if carrier else q
    return q if out is None else out.copy_(q)


def block_decode(q: torch.Tensor, scales: torch.Tensor, world: int,
                 numel: int, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Dequantize a [n_blocks, bs] payload (wire dtype or carrier) to
    [numel], averaged over ``world`` replicas (1 for the KV cache), in
    fp32 and then rounded once to ``dtype`` (the reference's
    ``.astype(dtype)``)."""
    vals = q.to(torch.float32) * scales[:, None]
    return div_rn(vals.reshape(-1)[:numel], world).to(dtype)


def block_residual(flat: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                   numel: int) -> torch.Tensor:
    """Error-feedback residual of a blockwise encode: the local input
    minus its own dequantized value (no averaging: local error)."""
    deq = (q.to(torch.float32) * scales[:, None]).reshape(-1)[:numel]
    return flat.to(torch.float32) - deq


def _block_kernel_ops():
    """The blockwise encode/decode pair: the wrappers of ``ops/codec.py``,
    which run the CUDA kernels on a CUDA tensor and the plain versions
    above on a CPU tensor."""
    from ..ops import codec as _codec

    return _codec.block_encode, _codec.block_decode


# ------------------------------------------------------------------ buckets
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


# ------------------------------------------------------------ communicator
def record_sync_metrics(codec: str, collectives: int, comm_bytes: int,
                        path: str):
    """One gradient-sync round into the process-global metric families,
    shared by the eager sync and the train step (``path="traced"``, the
    reference's label for the in-step sync)."""
    _m_syncs.inc()
    _m_coll.labels(codec=codec, path=path).inc(collectives)
    _m_bytes.labels(codec=codec, path=path).inc(comm_bytes)


_RS_LATER = ("use_reduce_scatter (the ZeRO stage-2 reduce_scatter -> "
             "all_gather decomposition) is not ported yet (ROADMAP Queue A "
             "2, the ZeRO remainder)")


class GradCommunicator:
    """Coalesced gradient synchronizer over ``torch.distributed``.

    ``sync(params)`` reduces every parameter's ``.grad`` bucket by bucket
    (AVG over the ranks) and writes the result back into the ``.grad``
    tensors in place. ``.stats`` holds the last sync's accounting:
    ``{"codec", "path", "n_params" (eager) or "world" (traced),
    "n_buckets", "collectives", "comm_bytes"}``, with ``comm_bytes`` the
    actual wire format's bytes.
    """

    def __init__(self, config: Optional[GradCommConfig] = None, group=None):
        self.config = config or GradCommConfig()
        self.group = group
        self._buckets: Optional[List[GradBucket]] = None
        self._bucket_key = None
        self._residuals = {}          # bucket index -> fp32 flat residual
        # bucket index -> (carrier [nb, bs], scales [nb]) the blockwise
        # encode writes and the all-reduce sums in place, kept across
        # steps so a consumer's pointers hold
        self._wire = {}
        self.stats = {"codec": self.config.codec, "path": "eager",
                      "n_params": 0, "n_buckets": 0, "collectives": 0,
                      "comm_bytes": 0}

    # ------------------------------------------------------------- planning
    def buckets_for(self, params, dtypes=None) -> List[GradBucket]:
        """Build (and cache) the bucket assignment for this param list."""
        dtypes = list(dtypes or [p.dtype for p in params])
        key = tuple((tuple(p.shape), dtype_name(dt))
                    for p, dt in zip(params, dtypes))
        if self._buckets is None or key != self._bucket_key:
            self._buckets = build_buckets(
                params, self.config.comm_buffer_size,
                self.config.last_comm_buffer_size, dtypes=dtypes)
            # residuals just restored by load_state_dict belong to this
            # key and survive the first build; a new assignment drops them
            if key != self._bucket_key:
                self._residuals.clear()
            self._wire.clear()
            self._bucket_key = key
        return self._buckets

    # ------------------------------------------------------------ job state
    def state_dict(self) -> dict:
        """Resume-critical state: the error-feedback residuals (numpy,
        keyed by bucket) and the bucket key they belong to."""
        return {
            "codec": self.config.codec,
            "error_feedback": self.config.error_feedback,
            "block_size": self.config.block_size,
            "bucket_key": self._bucket_key,
            "residuals": {int(i): r.detach().cpu().numpy()
                          for i, r in self._residuals.items()},
        }

    def load_state_dict(self, state: dict):
        """Restore ``state_dict()`` output; the codec (and, for the
        blockwise codecs, the block size) must match."""
        if state.get("codec") != self.config.codec:
            raise ValueError(
                f"grad_comm state codec mismatch: checkpoint has "
                f"{state.get('codec')!r}, communicator runs "
                f"{self.config.codec!r} — resume with the same wire codec")
        ckpt_bs = state.get("block_size")
        if (self.config.codec in BLOCK_CODECS and ckpt_bs is not None
                and int(ckpt_bs) != self.config.block_size):
            raise ValueError(
                f"grad_comm state block_size mismatch: checkpoint has "
                f"{ckpt_bs}, communicator runs {self.config.block_size} — "
                f"a different scale granularity silently changes the "
                f"quantization the residuals were computed against")
        self._bucket_key = state.get("bucket_key")
        self._residuals = {int(i): torch.as_tensor(np.asarray(r))
                           for i, r in (state.get("residuals") or {}).items()}

    def residual(self, bucket: GradBucket, device) -> Optional[torch.Tensor]:
        """The bucket's carried residual on ``device`` (None before the
        first reduction or without error feedback)."""
        r = self._residuals.get(bucket.index)
        if r is not None and r.device != torch.device(device):
            r = self._residuals[bucket.index] = r.to(device)
        return r

    # ----------------------------------------------------------------- sync
    def sync(self, params, world: Optional[int] = None,
             use_reduce_scatter: bool = False, *, path: str = "eager",
             flats=None, payload_only: bool = False):
        """All-reduce (AVG) the ``.grad`` of every parameter, bucketed and
        encoded, and write the result back into the ``.grad`` tensors;
        ``world`` defaults to the process world size. The residuals and
        ``stats`` are kept here.

        ``flats`` are the buckets' flat gradients when the caller already
        holds them in this plan's layout (``FusedFlatUpdater``'s buffers),
        else each bucket is gathered from ``.grad``. ``payload_only``
        (blockwise codecs) stops every bucket at its summed payload: the
        ``.grad`` tensors are left as they are, and the buckets' ``(q_sum,
        scales)`` are returned for ``FusedFlatUpdater.step_dequant``.
        ``path="traced"`` is the reference's label for the in-step sync;
        its ``stats`` carry the world size, as the reference's step
        records them, where the eager sync's carry the parameter count."""
        if use_reduce_scatter:
            raise NotImplementedError(_RS_LATER)
        params = [p for p in params if p.grad is not None]
        if world is None:
            from .env import get_world_size

            world = get_world_size()
        self.stats = {"codec": self.config.codec, "path": path,
                      "n_buckets": 0, "collectives": 0, "comm_bytes": 0}
        if path == "traced":
            self.stats["world"] = int(world)
        else:
            self.stats["n_params"] = len(params)
        if world <= 1 or not params:
            return [] if payload_only else None
        buckets = self.buckets_for(params, [p.grad.dtype for p in params])
        self.stats["n_buckets"] = len(buckets)
        ef = self.config.error_feedback and self.config.codec in EF_CODECS
        payloads = []
        with torch.no_grad(), torch.profiler.record_function("comm"):
            for b in buckets:
                flat = (self._flatten_bucket(b, params) if flats is None
                        else flats[b.index])
                residual = self.residual(b, flat.device) if ef else None
                if payload_only:
                    q_sum, scales, new_res, wire_bytes, n_coll = \
                        self.reduce_bucket_payload(b, flat, world,
                                                   residual=residual)
                    payloads.append((q_sum, scales))
                else:
                    reduced, new_res, wire_bytes, n_coll = \
                        self.reduce_bucket(b, flat, world, residual=residual)
                    self._scatter_bucket(b, params, reduced)
                if new_res is not None:
                    self._residuals[b.index] = new_res
                self.stats["collectives"] += n_coll
                self.stats["comm_bytes"] += wire_bytes
        self._record_metrics(buckets, path)
        return payloads if payload_only else None

    @staticmethod
    def _flatten_bucket(bucket: GradBucket, params) -> torch.Tensor:
        if len(bucket.param_indices) == 1:
            return params[bucket.param_indices[0]].grad.reshape(-1)
        return torch.cat([params[pi].grad.reshape(-1)
                          for pi in bucket.param_indices])

    @staticmethod
    def _scatter_bucket(bucket: GradBucket, params, reduced):
        """Write a reduced flat buffer back into the ``.grad`` tensors."""
        for pi, off, n, shape in zip(bucket.param_indices, bucket.offsets,
                                     bucket.numels, bucket.shapes):
            params[pi].grad.copy_(reduced[off:off + n].view(shape))

    def _record_metrics(self, buckets, path: str):
        record_sync_metrics(self.config.codec, self.stats["collectives"],
                            self.stats["comm_bytes"], path)
        for b in buckets:
            cap_mb = (self.config.last_comm_buffer_size if b.index == 0
                      else self.config.comm_buffer_size)
            _m_fill.observe(b.nbytes / (cap_mb * _MB))

    def _wire_buffers(self, bucket: GradBucket, device):
        """The bucket's carrier and scale buffers on ``device``, made at
        its first reduction and reused while the plan holds."""
        codec, bs = self.config.codec, self.config.block_size
        nb = n_scale_blocks(bucket.size, bs)
        bufs = self._wire.get(bucket.index)
        if bufs is None or bufs[0].shape != (nb, bs) \
                or bufs[0].device != torch.device(device):
            bufs = self._wire[bucket.index] = (
                torch.empty((nb, bs), dtype=CARRIER_DTYPE[codec],
                            device=device),
                torch.empty((nb,), dtype=torch.float32, device=device))
        return bufs

    def reduce_bucket_payload(self, bucket: GradBucket, flat, world: int,
                              residual=None):
        """Blockwise reduce that stops at the summed payload: returns
        ``(q_sum, scales, new_residual, wire_bytes, collectives)`` with
        ``q_sum`` the [n_blocks, block_size] carrier summed over ranks.
        The encode half is ``reduce_bucket``'s blockwise branch; the
        decode moves into the fused update kernel. ``flat`` is fp32 or
        bf16; with error feedback and a residual the sum is fp32, as in
        the reference, else a bf16 bucket is encoded from bf16 where it
        lies. ``q_sum`` and ``scales`` are the communicator's buffers of
        the bucket: the same tensors every step, overwritten by the
        next reduction of the bucket."""
        codec = self.config.codec
        if codec not in BLOCK_CODECS:
            raise ValueError(
                f"reduce_bucket_payload needs a blockwise codec, got "
                f"{codec!r}")
        bs = self.config.block_size
        ef = self.config.error_feedback
        if ef and residual is not None:
            flat = flat.to(torch.float32) + residual
        enc, _dec = _block_kernel_ops()
        q, scales = self._wire_buffers(bucket, flat.device)
        absmax = block_absmax(flat, bs)
        _coll.all_reduce(absmax, op=ReduceOp.SUM, group=self.group)
        scales.copy_(block_scales(absmax, codec))
        enc(flat, scales, bs, codec, carrier=True, out=q)
        new_res = block_residual(flat, q, scales, bucket.size) if ef \
            else None
        _coll.all_reduce(q, op=ReduceOp.SUM, group=self.group)
        wire_bytes = (bucket.size * _WIRE_ITEMSIZE[codec]
                      + scale_bytes(bucket.size, bs))
        return q, scales, new_res, wire_bytes, 2

    def reduce_bucket(self, bucket: GradBucket, flat, world: int,
                      use_reduce_scatter: bool = False, residual=None):
        """Reduce one flat bucket under the configured codec. ``residual``
        is the incoming error-feedback residual (or None); returns
        ``(reduced, new_residual, wire_bytes, collectives)``, with
        ``reduced`` a new tensor in the bucket's dtype and
        ``new_residual`` None for codecs without error feedback."""
        if use_reduce_scatter:
            raise NotImplementedError(_RS_LATER)
        codec = self.config.codec
        ef = self.config.error_feedback and codec in EF_CODECS
        new_res = None
        if codec == "int8":
            if ef and residual is not None:
                flat = flat.to(torch.float32) + residual
            # MAX over ranks: every rank quantizes with the same step
            scale = int8_scale(flat)
            _coll.all_reduce(scale, op=ReduceOp.MAX, group=self.group)
            q = int8_encode(flat, scale)
            if ef:
                new_res = int8_residual(flat, q, scale)
            _coll.all_reduce(q, op=ReduceOp.SUM, group=self.group)
            reduced = int8_decode(q, scale, world, bucket.dtype)
            wire_bytes = bucket.size * _WIRE_ITEMSIZE["int8"] + 4
            n_coll = 2
        elif codec in BLOCK_CODECS:
            q, scales, new_res, wire_bytes, n_coll = \
                self.reduce_bucket_payload(bucket, flat, world,
                                           residual=residual if ef else None)
            _enc, dec = _block_kernel_ops()
            reduced = dec(q, scales, world, bucket.size, dtype=bucket.dtype)
        elif codec == "bf16" and bucket.dtype.itemsize > 2:
            wire = encode_bf16(flat)
            _coll.all_reduce(wire, op=ReduceOp.AVG, group=self.group)
            reduced = decode_bf16(wire, bucket.dtype)
            wire_bytes = bucket.size * _WIRE_ITEMSIZE["bf16"]
            n_coll = 1
        else:
            reduced = flat.clone()
            _coll.all_reduce(reduced, op=ReduceOp.AVG, group=self.group)
            wire_bytes = bucket.size * flat.dtype.itemsize
            n_coll = 1
        return reduced, new_res, wire_bytes, n_coll

    def describe(self) -> list:
        """One row per bucket of the current plan."""
        if not self._buckets:
            return []
        return [{
            "bucket": b.index,
            "dtype": dtype_name(b.dtype),
            "n_params": len(b.param_indices),
            "numel": b.size,
            "mb": round(b.nbytes / _MB, 4),
        } for b in self._buckets]

    def __repr__(self):
        return (f"GradCommunicator({self.config!r}, "
                f"buckets={len(self._buckets or [])})")
