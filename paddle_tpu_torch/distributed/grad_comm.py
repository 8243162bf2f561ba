"""Gradient wire codecs, the bucket plan and the bucketed communicator
(reference: ``paddle_tpu/distributed/grad_comm.py``: the whole module,
``CODECS`` to ``comm_plan``).

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

bf16 and fp16 buckets ride the blockwise codecs as the reference's do:
a 16-bit flat is encoded where it lies (the kernel lifts it to fp32,
exactly, as the reference's ``_as_blocks`` does), unless error feedback
adds the fp32 residual first, which makes the sum fp32; the residual is
fp32; the decode rounds the fp32 ``q * scale / world`` once to the
bucket's dtype (fp16 subnormals kept, overflow to inf).

fp8 range: ``scales = absmax / 448`` keeps ``|x / s| <= 448 * (1 + ulp)``,
which rounds to 448, so the cast never sees an out-of-range value
(where torch saturates and ml_dtypes gives NaN, the two would differ).

``use_reduce_scatter=True`` (the ZeRO stage-2 gradient path) sends
each bucket's wire value through ``_reduce``'s reduce_scatter then
all_gather (padded to a multiple of the world), so each rank reduces
only its own shard; the blockwise payload rides the wire flat. Its
accounting is the reference's: the payload bytes twice and one more
collective a bucket. ``traced_reduce_scatter_quantized`` is the
reference's in-trace EQuARX decomposition (a shared-scale quantized
reduce_scatter, then an all_gather of the shard requantized with local
scales) as an eager function over the process group, its encodes and
decodes through ``ops/codec.py``. ``config_from_strategy`` reads a
``DistributedStrategy``; ``comm_plan`` is the host-side traffic plan.
The overlapped communicator is ``distributed/overlap.py``.
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
           "build_buckets", "comm_plan", "config_from_strategy",
           "traced_reduce_scatter_quantized", "record_sync_metrics",
           "n_scale_blocks",
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
    steps; int8 and the blockwise codecs), ``overlap`` (launch each
    bucket's collective as backward completes it:
    ``overlap.communicator_for`` builds an ``OverlappedGradCommunicator``)
    and ``block_size`` (elements per abs-max scale of the blockwise
    codecs). Validation and messages are the reference's."""

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


def traced_reduce_scatter_quantized(flat, axis, world: int,
                                    config: GradCommConfig, residual=None):
    """EQuARX's reduce_scatter on the blockwise wire (reference: the
    in-trace function of the same name), eager over the process group
    ``axis`` (a ``collective.Group``, or None for the world): both halves
    of the ring decomposition ship the 1-byte format with their fp32
    block scales beside it.

    RS half: the buffer (plus ``residual``) is padded so every rank's
    shard is a whole number of blocks, encoded with the shared scales
    (the per-block abs-max summed over the ranks) into the summable
    carrier, reduce-scattered, and this rank's shard decoded with its
    slice of the scales. AG half: the fp32 shard is requantized with
    local scales, the 1-byte payload and the scales are all-gathered and
    every shard decoded with its sender's scales. Every encode runs
    ``codec_encode`` and every decode ``codec_decode`` on the card.

    Returns ``(full, shard, new_residual, wire_bytes, collectives)``:
    the re-assembled reduced buffer (AVG) and this rank's shard in the
    input's dtype, the RS half's error-feedback residual (None without
    error feedback; the AG half's requantization error is not fed back),
    the wire bytes of both halves and the collective count (4)."""
    codec = config.codec
    if codec not in BLOCK_CODECS:
        raise ValueError(
            f"traced_reduce_scatter_quantized needs a blockwise codec, "
            f"got {codec!r}")
    from .env import get_rank

    if _coll._nranks(axis) != world:
        raise ValueError(f"traced_reduce_scatter_quantized over "
                         f"{_coll._nranks(axis)} ranks with world={world}")
    bs = config.block_size
    flat = flat.reshape(-1)
    n = flat.numel()
    in_dtype = flat.dtype
    chunk_blocks = n_scale_blocks(n_scale_blocks(n, world), bs)
    chunk = chunk_blocks * bs
    padded = world * chunk
    x = flat.to(torch.float32)
    if residual is not None:
        x = x + residual
    if padded > n:
        x = torch.cat([x, x.new_zeros(padded - n)])
    enc, dec = _block_kernel_ops()
    # ---- RS half: shared blockwise scales, integer payload
    absmax = block_absmax(x, bs)
    _coll.all_reduce(absmax, op=ReduceOp.SUM, group=axis)
    scales = block_scales(absmax, codec)
    q = enc(x, scales, bs, codec, carrier=True)
    new_res = (block_residual(x[:n], q, scales, n) if config.error_feedback
               else None)
    q_shard = _coll.reduce_scatter(q.reshape(-1), op=ReduceOp.SUM,
                                   group=axis)
    rank = get_rank() if world > 1 else 0
    if axis is not None and axis.ranks:
        rank = axis.get_group_rank(rank)
    lo = rank * chunk_blocks
    shard = dec(q_shard.reshape(-1, bs), scales[lo:lo + chunk_blocks],
                world, chunk)
    # ---- AG half: the shard requantized with local scales; the 1-byte
    # payload (as bytes) and the scales gathered
    s2 = block_scales(block_absmax(shard, bs), codec)
    q2 = enc(shard, s2, bs, codec)
    gq = _coll.all_gather(None, q2.view(torch.uint8), group=axis)
    gs = _coll.all_gather(None, s2, group=axis)
    full = dec(gq.reshape(-1, bs).view(q2.dtype), gs.reshape(-1), 1, n,
               dtype=in_dtype)
    wire_bytes = 2 * (padded * _WIRE_ITEMSIZE[codec]
                      + scale_bytes(padded, bs))
    return full, shard.to(in_dtype), new_res, wire_bytes, 4


class GradCommunicator:
    """Coalesced gradient synchronizer over ``torch.distributed``.

    ``sync(params)`` reduces every parameter's ``.grad`` bucket by bucket
    (AVG over the ranks) and writes the result back into the ``.grad``
    tensors in place; with ``use_reduce_scatter`` each bucket's wire
    value goes through reduce_scatter then all_gather (``_reduce``).
    ``.stats`` holds the last sync's accounting:
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
        records them, where the eager sync's carry the parameter count.
        ``use_reduce_scatter`` (not with ``payload_only``) sends every
        bucket through reduce_scatter then all_gather."""
        if use_reduce_scatter and payload_only:
            raise ValueError("payload_only stops at the all-reduced "
                             "payload; use_reduce_scatter decodes")
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
        payloads = []
        with torch.no_grad(), torch.profiler.record_function("comm"):
            for b in buckets:
                flat = (self._flatten_bucket(b, params) if flats is None
                        else flats[b.index])
                if payload_only:
                    payloads.append(self._sync_bucket(b, flat, world,
                                                      payload=True))
                else:
                    self._scatter_bucket(b, params, self._sync_bucket(
                        b, flat, world, use_reduce_scatter))
        self._record_metrics(buckets, path)
        return payloads if payload_only else None

    def _sync_bucket(self, bucket: GradBucket, flat, world: int,
                     use_reduce_scatter: bool = False, payload=False):
        """``reduce_bucket`` (or, with ``payload``,
        ``reduce_bucket_payload``, returning ``(q_sum, scales)``) with the
        residual taken from and kept in ``_residuals`` and the accounting
        added to ``stats``: one bucket of the eager sync, the overlapped
        lane's unit of work."""
        ef = self.config.error_feedback and self.config.codec in EF_CODECS
        residual = self.residual(bucket, flat.device) if ef else None
        if payload:
            q_sum, scales, new_res, wire_bytes, n_coll = \
                self.reduce_bucket_payload(bucket, flat, world,
                                           residual=residual)
            reduced = (q_sum, scales)
        else:
            reduced, new_res, wire_bytes, n_coll = self.reduce_bucket(
                bucket, flat, world, use_reduce_scatter=use_reduce_scatter,
                residual=residual)
        if new_res is not None:
            self._residuals[bucket.index] = new_res
        self.stats["collectives"] += n_coll
        self.stats["comm_bytes"] += wire_bytes
        return reduced

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

    def _record_metrics(self, buckets, path: str = "eager"):
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
        ``new_residual`` None for codecs without error feedback. With
        ``use_reduce_scatter`` the wire value goes through ``_reduce``'s
        reduce_scatter then all_gather: the payload's bytes count twice
        and the pair one collective more."""
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
            q = self._reduce(q, ReduceOp.SUM, use_reduce_scatter, world)
            reduced = int8_decode(q, scale, world, bucket.dtype)
            wire_bytes = bucket.size * _WIRE_ITEMSIZE["int8"] + 4
            n_coll = 2
        elif codec in BLOCK_CODECS and use_reduce_scatter:
            bs = self.config.block_size
            if ef and residual is not None:
                flat = flat.to(torch.float32) + residual
            enc, dec = _block_kernel_ops()
            absmax = block_absmax(flat, bs)
            _coll.all_reduce(absmax, op=ReduceOp.SUM, group=self.group)
            scales = block_scales(absmax, codec)
            q = enc(flat, scales, bs, codec, carrier=True)
            if ef:
                new_res = block_residual(flat, q, scales, bucket.size)
            # the (n_blocks, block_size) payload rides the wire flat
            q_sum = self._reduce(q.reshape(-1), ReduceOp.SUM, True,
                                 world).reshape(q.shape)
            reduced = dec(q_sum, scales, world, bucket.size,
                          dtype=bucket.dtype)
            wire_bytes = (bucket.size * _WIRE_ITEMSIZE[codec]
                          + scale_bytes(bucket.size, bs))
            n_coll = 2
        elif codec in BLOCK_CODECS:
            q, scales, new_res, wire_bytes, n_coll = \
                self.reduce_bucket_payload(bucket, flat, world,
                                           residual=residual if ef else None)
            _enc, dec = _block_kernel_ops()
            reduced = dec(q, scales, world, bucket.size, dtype=bucket.dtype)
        elif codec == "bf16" and bucket.dtype.itemsize > 2:
            reduced = decode_bf16(
                self._reduce(encode_bf16(flat), ReduceOp.AVG,
                             use_reduce_scatter, world), bucket.dtype)
            wire_bytes = bucket.size * _WIRE_ITEMSIZE["bf16"]
            n_coll = 1
        else:
            reduced = self._reduce(flat, ReduceOp.AVG, use_reduce_scatter,
                                   world)
            wire_bytes = bucket.size * flat.dtype.itemsize
            n_coll = 1
        if use_reduce_scatter:
            # the payload crosses the wire twice (reduce_scatter half +
            # all_gather half) and counts as two collectives
            payload = wire_bytes - (4 if codec == "int8" else 0) \
                - (scale_bytes(bucket.size, self.config.block_size)
                   if codec in BLOCK_CODECS else 0)
            wire_bytes += payload
            n_coll += 1
        return reduced, new_res, wire_bytes, n_coll

    def _reduce(self, wire_val, op, use_reduce_scatter: bool, world: int):
        """One flat wire value reduced over the ranks, as a new tensor:
        all-reduced, or with ``use_reduce_scatter`` padded to a multiple
        of ``world``, reduce-scattered (each rank reduces its own shard)
        and all-gathered back."""
        if use_reduce_scatter:
            n = wire_val.numel()
            pad = (-n) % world
            if pad:
                wire_val = torch.cat([wire_val, wire_val.new_zeros(pad)])
            shard = _coll.reduce_scatter(wire_val, op=op, group=self.group)
            full = _coll.all_gather(None, shard, group=self.group)
            return full.reshape(-1)[:n]
        out = wire_val.clone()
        _coll.all_reduce(out, op=op, group=self.group)
        return out

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


def config_from_strategy(strategy, comm_buffer_size: float = 25,
                         last_comm_buffer_size: float = 1,
                         default_codec: str = "fp32") -> GradCommConfig:
    """The wire config of a ``DistributedStrategy``: its
    ``grad_comm_configs`` when the ``grad_comm`` toggle is on; else bf16
    under ``fp16_allreduce``; else ``default_codec`` with the caller's
    bucket caps."""
    if strategy is not None and getattr(strategy, "grad_comm", False):
        gc = strategy.grad_comm_configs
        return GradCommConfig(
            codec=gc["codec"],
            comm_buffer_size=gc["comm_buffer_size_MB"],
            last_comm_buffer_size=gc["last_comm_buffer_size_MB"],
            error_feedback=gc["error_feedback"],
            overlap=gc.get("overlap", False),
            block_size=gc.get("block_size", 1024))
    codec = ("bf16" if strategy is not None
             and getattr(strategy, "fp16_allreduce", False)
             else default_codec)
    return GradCommConfig(codec=codec, comm_buffer_size=comm_buffer_size,
                          last_comm_buffer_size=last_comm_buffer_size)


def comm_plan(params, config: Optional[GradCommConfig] = None,
              world: int = 2) -> dict:
    """Host-side wire plan of one gradient sync of ``params`` (those with
    ``requires_grad``) under ``config``: buckets, collectives and wire
    bytes a step beside the per-parameter baseline. No collective runs."""
    config = config or GradCommConfig()
    params = [p for p in params if p.requires_grad]
    buckets = build_buckets(params, config.comm_buffer_size,
                            config.last_comm_buffer_size)
    total_numel = sum(b.size for b in buckets)
    grad_bytes = sum(b.nbytes for b in buckets)
    per_elem = _WIRE_ITEMSIZE[config.codec]
    if config.codec == "bf16":
        # bf16 halves only wider-than-16-bit gradients
        comm_bytes = sum(b.size * min(per_elem, b.dtype.itemsize)
                         for b in buckets)
    else:
        comm_bytes = total_numel * per_elem
    collectives = len(buckets)
    if config.codec == "int8":
        collectives *= 2
        comm_bytes += 4 * len(buckets)
    elif config.codec in BLOCK_CODECS:
        collectives *= 2
        comm_bytes += sum(scale_bytes(b.size, config.block_size)
                          for b in buckets)
    return {
        "codec": config.codec,
        "world": int(world),
        "n_params": len(params),
        "n_buckets": len(buckets),
        "total_grad_numel": int(total_numel),
        "grad_bytes": int(grad_bytes),
        "collectives_per_step": int(collectives),
        "comm_bytes_per_step": int(comm_bytes),
        "per_param_collectives": len(params),
        "per_param_comm_bytes": int(grad_bytes),
        "bucket_bound": int(math.ceil(grad_bytes / _MB /
                                      config.comm_buffer_size)
                            + len({b.dtype for b in buckets}) + 1),
    }
