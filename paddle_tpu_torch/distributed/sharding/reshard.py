"""Elastic resharding of ZeRO states from world N to M, on the host
(reference: ``paddle_tpu/distributed/sharding/reshard.py``: ``chunk_of``,
``rechunk_flat``, ``assemble_full_buckets``, ``reshard_zero3_states``,
``reshard_slot_states``, ``reshard_residual_maps``, ``reshard_payloads``,
``reshard_report``), in numpy.

Every per-rank ZeRO artifact (the stage-3 parameter shards, the
``FusedFlatUpdater`` shard slots, the reduce_scatter gradient shards) is
``[rank * chunk, (rank + 1) * chunk)`` of one flat bucket zero-padded to
``world * chunk``, ``chunk = ceil(size / world)``. An N -> M transform
concatenates the N shards, strips the padding back to the bucket's size,
pads again for M and slices M shards: the same bytes, relabelled, so it
is bit-exact. Error-feedback residuals are whole-bucket and per rank:
they are summed over the old ranks and split 1/M to every new one
(``new_r = sum(old) / M``), which keeps the total error the next sync
adds; a single shared map (one process emulating the world) passes
through unchanged.

``reshard_checkpoint`` (a ``CheckpointManager``'s checkpoint, rewritten
in place) waits with ``save_group_sharded_checkpoint`` for the
checkpoint manager, ROADMAP Queue A item 14 (the rest).
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np

from ...framework.errors import CheckpointCorruptError
from ...observability.metrics import get_registry as _get_registry

__all__ = [
    "chunk_of", "rechunk_flat", "assemble_full_buckets",
    "reshard_zero3_states", "reshard_slot_states", "reshard_residual_maps",
    "reshard_payloads", "reshard_report",
]

_m_reshard_ms = _get_registry().gauge(
    "reshard_ms", help="wall ms of the last N->M checkpoint reshard")


def chunk_of(size: int, world: int) -> int:
    """Per-rank chunk of a flat bucket: ceil(size / world), the padding
    geometry of every sharded artifact."""
    size, world = int(size), int(world)
    return (size + (-size) % world) // world


def rechunk_flat(full: np.ndarray, size: int, world: int) -> List[np.ndarray]:
    """Slice an unpadded flat buffer into `world` padded rank chunks."""
    full = np.asarray(full).reshape(-1)[:size]
    c = chunk_of(size, world)
    pad = c * world - size
    if pad:
        full = np.concatenate([full, np.zeros((pad,), full.dtype)])
    return [full[r * c:(r + 1) * c] for r in range(world)]


def _bucket_sizes_of(state: dict, what: str) -> Dict[int, int]:
    sizes = state.get("bucket_sizes")
    if not sizes:
        raise CheckpointCorruptError(
            f"{what} predates elastic resharding: it carries no "
            f"'bucket_sizes', so the N-padding cannot be stripped before "
            f"re-chunking — re-save the checkpoint with this version "
            f"before changing the world size")
    return {int(i): int(n) for i, n in sizes.items()}


def _is_emulated_zero3(states: List[dict]) -> bool:
    return len(states) == 1 and bool(states[0].get("peer_shards"))


def assemble_full_buckets(states: List[dict]) -> Dict[int, np.ndarray]:
    """Reconstruct every flat bucket (unpadded) from zero3 shard states —
    either one emulated state (own + peer shards) or one state per rank."""
    sizes = _bucket_sizes_of(states[0], "zero3 shard state")
    old_world = int(states[0]["world"])
    full = {}
    if _is_emulated_zero3(states):
        st = states[0]
        own_rank = int(st["rank"])
        for i, size in sizes.items():
            parts = []
            for r in range(old_world):
                if r == own_rank:
                    parts.append(np.asarray(st["shards"][i]))
                else:
                    parts.append(np.asarray(st["peer_shards"][i][r]))
            full[i] = np.concatenate(parts)[:size]
    else:
        if len(states) != old_world:
            raise CheckpointCorruptError(
                f"zero3 reshard needs every rank's shard state: world is "
                f"{old_world} but {len(states)} states were given")
        by_rank = {int(s["rank"]): s for s in states}
        for i, size in sizes.items():
            parts = [np.asarray(by_rank[r]["shards"][i])
                     for r in range(old_world)]
            full[i] = np.concatenate(parts)[:size]
    return full


def reshard_zero3_states(states: List[dict], new_world: int) -> List[dict]:
    """N→M transform of `Stage3ParamShards.state_dict()` snapshots.

    Input/output style match: one emulated state in (own + peer shards) →
    one emulated state out at world M; N real per-rank states in → M out.
    fp32-bit-exact: the flat bucket bytes are only re-sliced.
    """
    new_world = int(new_world)
    sizes = _bucket_sizes_of(states[0], "zero3 shard state")
    full = assemble_full_buckets(states)
    key = states[0].get("bucket_key")
    emulated = _is_emulated_zero3(states)

    chunks = {i: rechunk_flat(full[i], sizes[i], new_world) for i in full}
    if emulated:
        out = {
            "bucket_key": key, "rank": 0, "world": new_world,
            "bucket_sizes": dict(sizes),
            "shards": {i: chunks[i][0] for i in chunks},
            "peer_shards": {i: {r: chunks[i][r]
                                for r in range(1, new_world)}
                            for i in chunks},
        }
        return [out]
    return [{
        "bucket_key": key, "rank": r, "world": new_world,
        "bucket_sizes": dict(sizes),
        "shards": {i: chunks[i][r] for i in chunks},
    } for r in range(new_world)]


def _is_scalar_slot(v) -> bool:
    return np.shape(v) == ()


def reshard_slot_states(slot_states: List[dict], new_world: int,
                        old_world: Optional[int] = None) -> List[dict]:
    """N→M transform of `FusedFlatUpdater.shard_slots_state()` snapshots.

    Slot buffers (Adam moments etc.) are laid out exactly like the
    parameter shards, so the transform is the same strip-and-re-chunk;
    scalar slots (shared beta pows) are identical on every rank and are
    copied through. Emulated input (rank 0's ``own`` + ``peer`` entries)
    yields emulated output; N per-rank states yield M.
    """
    new_world = int(new_world)
    sizes = _bucket_sizes_of(slot_states[0], "fused shard-slot state")
    emulated = len(slot_states) == 1 and bool(slot_states[0].get("peer"))
    if old_world is None:
        if emulated:
            old_world = 1 + max((r for (_i, r) in slot_states[0]["peer"]),
                                default=0)
        else:
            old_world = len(slot_states)

    def slots_of(rank: int, bucket: int) -> Optional[dict]:
        if emulated:
            st = slot_states[0]
            if rank == 0:
                return (st.get("own") or {}).get(bucket)
            return (st.get("peer") or {}).get((bucket, rank))
        return (slot_states[rank].get("own") or {}).get(bucket)

    buckets = sorted(sizes)
    # join: full flat buffer per (bucket, slot key); scalars from rank 0
    joined: Dict[int, Dict[str, object]] = {}
    for i in buckets:
        ref = slots_of(0, i)
        if ref is None:
            continue  # bucket never stepped — no slots to transform
        out = {}
        for k, v in ref.items():
            if _is_scalar_slot(v):
                out[k] = v
            else:
                parts = []
                for r in range(old_world):
                    s = slots_of(r, i)
                    if s is None:
                        raise CheckpointCorruptError(
                            f"fused shard slots for bucket {i} missing on "
                            f"rank {r} — every rank of a stepped bucket "
                            f"must carry its slot shard")
                    parts.append(np.asarray(s[k]))
                out[k] = np.concatenate(parts)[:sizes[i]]
        joined[i] = out

    def chunked(i: int, r: int) -> dict:
        out = {}
        for k, v in joined[i].items():
            if _is_scalar_slot(v):
                out[k] = v
            else:
                out[k] = rechunk_flat(v, sizes[i], new_world)[r]
        return out

    if emulated:
        return [{
            "own": {i: chunked(i, 0) for i in joined},
            "peer": {(i, r): chunked(i, r)
                     for i in joined for r in range(1, new_world)},
            "bucket_sizes": dict(sizes),
        }]
    return [{
        "own": {i: chunked(i, r) for i in joined},
        "peer": {},
        "bucket_sizes": dict(sizes),
    } for r in range(new_world)]


def reshard_residual_maps(maps: List[dict], new_count: int) -> List[dict]:
    """Error-feedback residual policy: sum per element across the old
    ranks, then re-split 1/M to every new rank — preserves the total
    error mass the next sync re-injects (Σ_new = Σ_old). A single shared
    map (single-process emulation: one communicator for the whole world)
    passes through unchanged."""
    new_count = int(new_count)
    maps = [m or {} for m in maps]
    if len(maps) == 1 and new_count == 1:
        return [dict(maps[0])]
    keys = sorted({int(k) for m in maps for k in m})
    summed = {}
    for k in keys:
        parts = [np.asarray(m[k], dtype=np.float32) for m in maps if k in m]
        summed[k] = np.sum(parts, axis=0)
    return [{k: summed[k] / new_count for k in keys}
            for _ in range(new_count)]


def _reshard_job_state(js: dict, rank: int, new_world: int,
                       residuals: Optional[dict]) -> dict:
    js = copy.deepcopy(js)
    js["rank"] = int(rank)
    if "zero3" in js and isinstance(js["zero3"], dict):
        js["zero3"] = dict(js["zero3"], world=int(new_world), rank=int(rank))
    if residuals is not None and "grad_comm" in js:
        js["grad_comm"] = dict(js["grad_comm"], residuals=residuals)
    return js


def reshard_payloads(payloads: List[dict], new_world: int) -> List[dict]:
    """Transform the per-rank payload dicts of one sharded checkpoint
    (`save_group_sharded_checkpoint`'s layout: optional ``zero3`` /
    ``model`` / ``optimizer`` / ``fused_shard_slots`` / ``job_state``
    entries) from their current sharding world to ``new_world``.

    Emulated checkpoints (one payload whose zero3 state carries peer
    shards) come back as one payload; real N-payload checkpoints come
    back as ``new_world`` payloads. Replicated entries (``model``,
    ``optimizer``) are taken from rank 0; rank-local ``job_state`` is
    re-derived per new rank with the residual re-split policy applied.
    """
    new_world = int(new_world)
    if not payloads:
        raise ValueError("reshard_payloads needs at least one payload")
    z3_states = [p["zero3"] for p in payloads if "zero3" in p]
    emulated = bool(z3_states) and _is_emulated_zero3(z3_states)
    out_count = 1 if emulated else new_world

    new_z3 = (reshard_zero3_states(z3_states, new_world)
              if z3_states else None)
    slot_states = [p["fused_shard_slots"] for p in payloads
                   if "fused_shard_slots" in p]
    new_slots = (reshard_slot_states(slot_states, new_world)
                 if slot_states else None)

    job_states = [p.get("job_state") for p in payloads]
    have_js = [js for js in job_states if js is not None]
    new_res = None
    if have_js and not emulated:
        res_maps = [(js.get("grad_comm") or {}).get("residuals") or {}
                    for js in have_js]
        if any(res_maps):
            new_res = reshard_residual_maps(res_maps, out_count)

    out = []
    for r in range(out_count):
        p = {}
        if new_z3 is not None:
            p["zero3"] = new_z3[r]
        elif "model" in payloads[0]:
            p["model"] = copy.deepcopy(payloads[0]["model"])
        if "optimizer" in payloads[0]:
            p["optimizer"] = copy.deepcopy(payloads[0]["optimizer"])
        if new_slots is not None:
            p["fused_shard_slots"] = new_slots[r]
        if have_js:
            base = job_states[r] if r < len(job_states) and \
                job_states[r] is not None else have_js[0]
            p["job_state"] = _reshard_job_state(
                base, r, new_world,
                new_res[r] if new_res is not None else None)
        out.append(p)
    return out


def reshard_report(params, config=None, old_world: int = 4,
                   new_world: int = 2, seed: int = 0) -> dict:
    """Time the N -> M zero3 shard transform on detached fakes of
    ``params``' shapes (host cost only) and check in passing that the
    new shards reassemble the full parameters bit for bit."""
    from ...framework.autograd import unwrap
    from ..grad_comm import GradCommConfig, GradCommunicator
    from .stage3 import Stage3ParamShards, _fake_params

    config = config or GradCommConfig()
    shapes_dtypes = [(tuple(p.shape), p.dtype) for p in map(unwrap, params)
                     if p.requires_grad]
    fakes = _fake_params(shapes_dtypes, seed=seed)
    want = [p.detach().numpy().copy() for p in fakes]
    store = Stage3ParamShards(fakes, GradCommunicator(config), rank=0,
                              world=old_world)
    store.shard_()
    state = store.state_dict()
    t0 = time.perf_counter()
    new_states = reshard_zero3_states([state], new_world)
    ms = (time.perf_counter() - t0) * 1e3
    # gather→rewrap reference: the transformed shards must reassemble to
    # the original full parameters bit for bit
    full = assemble_full_buckets(new_states)
    ok = True
    for b in store.buckets:
        flat = full[b.index]
        for pi, o, n, shape in zip(b.param_indices, b.offsets, b.numels,
                                   b.shapes):
            ok = ok and np.array_equal(
                flat[o:o + n].reshape(shape).astype(want[pi].dtype),
                want[pi])
    _m_reshard_ms.set(round(ms, 3))
    return {
        "from_world": int(old_world), "to_world": int(new_world),
        "n_buckets": len(store.buckets),
        "param_bytes_full": int(store.stats["param_bytes_full"]),
        "reshard_ms": round(ms, 3),
        "bit_identical": bool(ok),
    }
