"""ZeRO stage 3: parameters sharded at rest, gathered bucket by bucket
for the forward, the next layer's bucket prefetched on a lane (reference:
``paddle_tpu/distributed/sharding/stage3.py``: ``Stage3ParamShards`` and
``zero3_gather_report``).

The bucket layout is the communicator's (``buckets_for`` of the
trainable parameters), so the reduce_scatter gradient shard, the
optimizer's update shard and the at-rest parameter shard of bucket ``i``
are the same ``[rank * chunk, (rank + 1) * chunk)`` of one flat buffer
padded to ``world * chunk``, ``chunk = ceil(size / world)``.

Lifetime of a bucket::

    sharded --prefetch--> inflight --wait + scatter--> gathered
       ^                                                  |
       +----------------------- free ---------------------+

- **At rest** only this rank's shard of each bucket is resident (a
  tensor of its own). Every parameter's ``.data`` is a placeholder of
  its shape, dtype and device that holds one element, a NaN, expanded
  with stride 0: planning code that reads shapes (the bucket keys, the
  ``.grad`` views) works, and a read of a freed parameter's values
  gives NaN, which the loss shows.
- **Gather**: a forward pre-hook on each layer that owns parameters (or
  declared a use, ``register_external_use``) gathers its buckets, or
  waits for their prefetch, and points the parameters' ``.data`` at
  views of the gathered flat buffer; then it submits the next layer's
  buckets' all_gathers to a ``CollectiveLane`` ("zero3-gather-lane"), so
  their wire time runs under this layer's compute. The first bucket has
  nothing to run under and is gathered on the caller's thread ("sync").
  On the card the lane's stream waits for an event recorded at the
  launch (the step's shard update is queued before it), and the caller's
  stream for one recorded after the gather.
- **Free**: PyTorch's autograd saves a leaf parameter by reference, so
  a parameter whose ``.data`` is pointed at the placeholder after its
  forward would give the backward NaN (the reference frees after use
  because its tape keeps the forward-time values as residuals). Here a
  bucket used with grad enabled stays gathered until every one of its
  parameters has accumulated its gradient (a
  ``register_post_accumulate_grad_hook`` on each parameter; by then
  every backward node that saved the parameter has run), and is freed
  there, during backward. A forward under ``no_grad`` frees a bucket in
  the post-hook of the last layer that uses it, as the reference does.
  A bucket left gathered (a parameter that got no gradient) is freed by
  the next pass's begin or by ``commit_shard``.
- **What is resident**: between steps, the shards only
  (``param_bytes_per_rank``, 1/world of the parameters); during a
  forward with grad enabled, every bucket the forward has reached (the
  full parameters at its end, as the reference's residuals hold them);
  during backward, the buckets whose gradients are not all in; under
  ``no_grad``, at most the current layer's buckets and the prefetched
  next ones.
- **Update**: ``FusedFlatUpdater.step_sharded(..., param_store=store)``
  updates ``own_shard(i)`` in place and commits it (``commit_shard``
  frees any gathered copy, now stale).

A layer whose forward reads a parameter that another layer owns (GPT's
LM head reads the word embedding in ``GPTForCausalLM.forward``) must
declare it, ``register_external_use(layer, param)``, so its pre-hook
gathers the bucket; with grad enabled the bucket is still gathered from
the owner's forward, but a ``no_grad`` forward would read the
placeholder. The reference's self-healing "fallback" gather has no
counterpart: a placeholder cannot intercept the read. The
``zero3_gathers_total`` family (and ``gathers``) counts gathers by mode,
"prefetched" and "sync"; the reference's third mode, "fallback", stays
at 0.

Gathers are ``collective.all_gather`` of the shards. They run in
forward only (backward issues none), so they never interleave with the
overlapped gradient lane's collectives on the shared process group.
With no process group of ``world`` ranks (one process emulating them,
as the reference's tests do) the store keeps the other ranks' shards
too (``peer_shard``; on the shard's device) and assembles the full
buffer from them.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import collective as _coll
from ..grad_comm import GradCommConfig, GradCommunicator
from ..overlap import CollectiveLane, GatherFuture, _record_event, \
    _wait_event
from ...framework.autograd import unwrap
from ...observability.metrics import get_registry as _get_registry

__all__ = ["Stage3ParamShards", "zero3_gather_report"]

SHARDED, INFLIGHT, GATHERED = "sharded", "inflight", "gathered"

_m_param_bytes = _get_registry().gauge(
    "zero3_param_bytes_per_rank",
    help="device-resident parameter bytes at rest under ZeRO-3 (this "
         "rank's shards)")
_m_resident = _get_registry().gauge(
    "zero3_gathered_buckets",
    help="parameter buckets currently materialized full (gathered)")
_m_exposed = _get_registry().gauge(
    "zero3_exposed_gather_ms",
    help="exposed (not hidden under compute) parameter-gather ms of the "
         "last forward pass")
_m_gathers = _get_registry().counter(
    "zero3_gathers_total",
    help="parameter-bucket all_gathers by launch mode",
    labels=("mode",))

_placeholders: Dict[tuple, torch.Tensor] = {}


def _placeholder(p: torch.Tensor) -> torch.Tensor:
    """A freed parameter's ``.data``: one NaN of its dtype on its device,
    expanded to its shape."""
    key = (p.dtype, p.device)
    one = _placeholders.get(key)
    if one is None:
        one = _placeholders[key] = torch.full((), float("nan"),
                                              dtype=p.dtype, device=p.device)
    return one.expand(p.shape)


class Stage3ParamShards:
    """At-rest parameter shards of one model and their gather and free
    lifecycle (module docstring). ``world`` is the sharding degree (the
    process world by default) and ``rank`` this process's slice."""

    def __init__(self, params, communicator: Optional[GradCommunicator] = None,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 group=None, prefetch_ahead: int = 1,
                 free_after_use: bool = True,
                 config: Optional[GradCommConfig] = None):
        from ..env import get_rank, get_world_size

        self.params = [t for t in map(unwrap, params) if t.requires_grad]
        self.comm = communicator or GradCommunicator(config or
                                                     GradCommConfig())
        self.rank = get_rank() if rank is None else int(rank)
        self.world = get_world_size() if world is None else int(world)
        if self.world <= 1:
            raise ValueError(
                "Stage3ParamShards needs world > 1 — with one rank there is "
                "nothing to shard (group_sharded_parallel leaves the model "
                "unsharded in that case)")
        if not (0 <= self.rank < self.world):
            raise ValueError(f"rank {self.rank} outside world {self.world}")
        self.group = group if group is not None else self.comm.group
        self.prefetch_ahead = max(0, int(prefetch_ahead))
        self.free_after_use = bool(free_after_use)
        self.buckets = self.comm.buckets_for(self.params)
        self._by_param: Dict[int, int] = {}
        for b in self.buckets:
            for pi in b.param_indices:
                self._by_param[id(self.params[pi])] = b.index
        self._lane = CollectiveLane("zero3-gather-lane")
        self._lock = threading.Lock()
        self.emulated = _coll._nranks(self.group) < self.world
        self._shards: Dict[int, torch.Tensor] = {}
        self._peer_shards: Dict[int, Dict[int, torch.Tensor]] = {}
        self._state: Dict[int, str] = {}
        self._futures: Dict[int, GatherFuture] = {}
        self._hook_handles: List = []
        self._grad_handles: List = []
        self._model = None
        self._order = None
        self._layer_order: List = []       # [(layer, [bucket indices])]
        self._external: Dict[int, List] = {}    # id(layer) -> [params]
        self._uses_left: Dict[int, int] = {}
        self._grads_left: Dict[int, int] = {}
        self._grad_pass = False
        self._pass_active = False
        self.exposed_gather_s = 0.0        # since the last reset_exposed()
        self._pass_exposed_s = 0.0
        self.gathers = Counter()           # by mode
        self.sharded = False
        self.stats: Dict[str, object] = {
            "world": self.world, "rank": self.rank,
            "n_buckets": len(self.buckets),
            "param_bytes_full": sum(b.nbytes for b in self.buckets),
        }

    # ------------------------------------------------------------- geometry
    def _chunk(self, bucket) -> int:
        return -(-bucket.size // self.world)

    def param_bytes_per_rank(self) -> int:
        """Resident parameter bytes at rest (this rank's shards)."""
        return sum(self._chunk(b) * b.dtype.itemsize for b in self.buckets)

    def resident_buckets(self) -> List[int]:
        return [i for i, s in self._state.items() if s == GATHERED]

    # ------------------------------------------------------------- sharding
    @torch.no_grad()
    def shard_(self):
        """To the at-rest state: keep this rank's shard of every bucket,
        free the parameters. Idempotent."""
        if self.sharded:
            return self
        for b in self.buckets:
            chunk = self._chunk(b)
            flat = torch.cat([self.params[pi].data.reshape(-1)
                              for pi in b.param_indices])
            pad = chunk * self.world - b.size
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            self._shards[b.index] = flat[self.rank * chunk:
                                         (self.rank + 1) * chunk].clone()
            if self.emulated:
                self._peer_shards[b.index] = {
                    r: flat[r * chunk:(r + 1) * chunk].clone()
                    for r in range(self.world) if r != self.rank}
            self._state[b.index] = SHARDED
            del flat
            self._free_params(b)
        self.sharded = True
        _m_param_bytes.set(self.param_bytes_per_rank())
        _m_resident.set(0)
        return self

    def _free_params(self, bucket):
        for pi in bucket.param_indices:
            p = self.params[pi]
            p.data = _placeholder(p)

    # ------------------------------------------------------ gather lifecycle
    def prefetch_bucket(self, index: int):
        """Submit bucket ``index``'s all_gather to the lane (the
        layer-ahead prefetch); a no-op unless the bucket is at rest."""
        with self._lock:
            if (not self.sharded or self._state.get(index) != SHARDED
                    or index in self._futures):
                return None
            fut = GatherFuture(self.buckets[index])
            fut.launch_ns = time.perf_counter_ns()
            fut.ready = _record_event(self._shards[index].device)
            self._futures[index] = fut
            self._state[index] = INFLIGHT
        bucket = self.buckets[index]

        def job():
            fut.start_ns = time.perf_counter_ns()
            try:
                _wait_event(fut.ready)
                full = self._gather_full(bucket)
                fut.event = _record_event(full.device)
                if fut.event is not None:
                    fut.event.synchronize()
            except BaseException as e:   # raised at the wait
                fut._fail(e)
            else:
                fut._resolve(full)
            fut.end_ns = time.perf_counter_ns()

        self._lane.submit(job)
        self._count("prefetched")
        return fut

    def _count(self, mode: str):
        self.gathers[mode] += 1
        _m_gathers.labels(mode=mode).inc()

    def ensure_gathered(self, index: int, _mode: str = "sync"):
        """Make bucket ``index``'s parameters full: wait for its prefetch,
        or gather on this thread (exposed), and point the parameters at
        views of the gathered buffer. The exposed time is the wait for
        the gathered data."""
        if self._state.get(index) == GATHERED:
            return
        t0 = time.perf_counter()
        fut = self._futures.get(index)
        if fut is not None:
            try:
                full = fut.wait()
            except BaseException:
                # a failed prefetch must not wedge the bucket in flight
                with self._lock:
                    self._futures.pop(index, None)
                    self._state[index] = SHARDED
                raise
        else:
            full = self._gather_full(self.buckets[index])
            if full.device.type == "cuda":
                torch.cuda.current_stream(full.device).synchronize()
            self._count(_mode)
        exposed = time.perf_counter() - t0
        self.exposed_gather_s += exposed
        self._pass_exposed_s += exposed
        self._scatter_full(self.buckets[index], full)
        with self._lock:
            self._state[index] = GATHERED
            popped = self._futures.pop(index, None)
        if popped is not None:
            popped._value = None
        _m_resident.set(len(self.resident_buckets()))

    def free_bucket(self, index: int):
        """Back to rest: the parameters of bucket ``index`` become
        placeholders (the shard is the source of truth). Waits for a
        prefetch in flight first."""
        fut = self._futures.get(index)
        if fut is not None:
            fut._done.wait()
        with self._lock:
            self._futures.pop(index, None)
            self._state[index] = SHARDED
        self._free_params(self.buckets[index])
        _m_resident.set(len(self.resident_buckets()))

    def _gather_full(self, bucket) -> torch.Tensor:
        """The padded full flat buffer of ``bucket``: the ranks' shards
        all-gathered, or, emulated, assembled from the kept peers."""
        shard = self._shards[bucket.index]
        if self.emulated:
            return torch.cat([shard if r == self.rank
                              else self._peer_shards[bucket.index][r]
                              for r in range(self.world)])
        return _coll.all_gather(None, shard, group=self.group).reshape(-1)

    def _scatter_full(self, bucket, full):
        for pi, off, n, shape in zip(bucket.param_indices, bucket.offsets,
                                     bucket.numels, bucket.shapes):
            self.params[pi].data = full[off:off + n].view(shape)

    # ------------------------------------------------------- optimizer side
    def own_shard(self, index: int) -> torch.Tensor:
        """This rank's at-rest shard of bucket ``index`` (padded chunk)."""
        return self._shards[index]

    def peer_ranks(self) -> List[int]:
        return [r for r in range(self.world) if r != self.rank]

    def peer_shard(self, index: int, rank: int) -> torch.Tensor:
        return self._peer_shards[index][rank]

    def commit_shard(self, index: int, new_shard):
        """The optimizer's updated own shard becomes the at-rest value; a
        gathered copy of the bucket, now stale, is freed."""
        if new_shard is not self._shards[index]:
            self._shards[index] = new_shard
        if self._state.get(index) == GATHERED:
            self.free_bucket(index)
        _m_param_bytes.set(self.param_bytes_per_rank())

    def commit_peer_shard(self, index: int, rank: int, new_shard):
        """Emulation: another rank's updated shard."""
        if new_shard is not self._peer_shards[index][rank]:
            self._peer_shards[index][rank] = torch.as_tensor(new_shard)

    # ------------------------------------------------------------ model side
    def register_external_use(self, layer, param):
        """Declare that ``layer``'s forward reads ``param``, which another
        layer owns (tied weights): its pre-hook then gathers the bucket.
        Hooks already installed are installed again."""
        self._external.setdefault(id(layer), []).append(unwrap(param))
        if self._model is not None:
            self.install_hooks(self._model, self._order)

    def install_hooks(self, model, order=None):
        """The gather-ahead forward hooks, and the free-on-gradient hooks.
        ``order`` (a list of modules) defaults to ``named_modules()``'s
        pre-order, the execution order of a model built in order."""
        self.remove_hooks()
        self._model, self._order = model, order
        if order is None:
            order = [m for _, m in model.named_modules()]
        param_ids = set(self._by_param)
        seq = []
        for layer in order:
            own = [p for p in layer._parameters.values()
                   if p is not None and id(p) in param_ids]
            own += [p for p in self._external.get(id(layer), [])
                    if id(p) in param_ids]
            if own:
                seq.append((layer, sorted({self._by_param[id(p)]
                                           for p in own})))
        self._layer_order = seq
        # the pass brackets on the root: registered first and last, so its
        # pre-hook runs before, and its post-hook after, any layer hook of
        # the root itself
        self._hook_handles.append(
            model.register_forward_pre_hook(self._pass_begin_hook))
        for k, (layer, _need) in enumerate(seq):
            self._hook_handles.append(
                layer.register_forward_pre_hook(self._make_pre_hook(k)))
            self._hook_handles.append(
                layer.register_forward_hook(self._make_post_hook(k)))
        self._hook_handles.append(
            model.register_forward_hook(self._pass_end_hook))
        self._grad_handles = [p.register_post_accumulate_grad_hook(
            self._on_grad) for p in self.params]
        return self

    def remove_hooks(self):
        for h in self._hook_handles + self._grad_handles:
            h.remove()
        self._hook_handles, self._grad_handles = [], []
        self._model = self._order = None

    def _begin_pass(self):
        # a pass aborted by an exception, or a bucket whose parameters got
        # no gradient: back to rest first
        for i in list(self.resident_buckets()):
            self.free_bucket(i)
        self._uses_left = {}
        for _layer, need in self._layer_order:
            for bi in need:
                self._uses_left[bi] = self._uses_left.get(bi, 0) + 1
        self._grad_pass = torch.is_grad_enabled()
        self._grads_left = (
            {b.index: len(b.param_indices) for b in self.buckets}
            if self._grad_pass else {})
        self._pass_exposed_s = 0.0
        self._pass_active = True

    def _end_pass(self):
        if self.free_after_use and not self._grad_pass:
            for i in list(self.resident_buckets()):
                self.free_bucket(i)
        self._pass_active = False
        self.stats["exposed_gather_s_last_pass"] = self._pass_exposed_s
        _m_exposed.set(round(self._pass_exposed_s * 1e3, 6))

    def _pass_begin_hook(self, layer, inputs):
        if self.sharded:
            self._begin_pass()

    def _pass_end_hook(self, layer, inputs, outputs):
        if self.sharded and self._pass_active:
            self._end_pass()

    def _make_pre_hook(self, k: int):
        def hook(layer, inputs):
            if not self.sharded:
                return None
            if not self._pass_active:
                # a sublayer driven on its own: arm the pass here
                self._begin_pass()
            for bi in self._layer_order[k][1]:
                self.ensure_gathered(bi)
            # the layer-ahead prefetch
            for j in range(k + 1, min(k + 1 + self.prefetch_ahead,
                                      len(self._layer_order))):
                for bi in self._layer_order[j][1]:
                    self.prefetch_bucket(bi)
            return None

        return hook

    def _make_post_hook(self, k: int):
        def hook(layer, inputs, outputs):
            if not self.sharded or not self._pass_active \
                    or self._grad_pass:
                return None
            for bi in self._layer_order[k][1]:
                left = max(0, self._uses_left.get(bi, 0) - 1)
                self._uses_left[bi] = left
                if left == 0 and self.free_after_use:
                    self.free_bucket(bi)
            return None

        return hook

    def _on_grad(self, param):
        """A parameter's gradient is in: free its bucket once all are."""
        bi = self._by_param.get(id(param))
        if bi is None or bi not in self._grads_left:
            return
        self._grads_left[bi] -= 1
        if self._grads_left[bi] == 0:
            del self._grads_left[bi]
            if self.free_after_use and self._state.get(bi) == GATHERED:
                self.free_bucket(bi)

    @contextlib.contextmanager
    def materialize(self):
        """Every bucket gathered for the block (whole-model reads such as
        ``save_group_sharded_model``); freed again on every exit."""
        if not self.sharded:
            yield self
            return
        try:
            for b in self.buckets:
                self.ensure_gathered(b.index)
            yield self
        finally:
            for b in self.buckets:
                self.free_bucket(b.index)

    def unshard_(self):
        """Leave stage 3 for good: gather every bucket, drop the shards
        and the hooks (the inverse of ``shard_()``)."""
        if not self.sharded:
            return self
        for b in self.buckets:
            self.ensure_gathered(b.index)
        self.remove_hooks()
        self.sharded = False
        self._shards.clear()
        self._peer_shards.clear()
        self._futures.clear()
        self._state.clear()
        _m_param_bytes.set(0)
        _m_resident.set(0)
        return self

    def reset_exposed(self):
        self.exposed_gather_s = 0.0

    # ------------------------------------------------------------ state io
    def state_dict(self) -> dict:
        """This rank's shards (and, emulated, the peers') as numpy, with
        the bucket key and the unpadded bucket sizes."""
        out = {
            "bucket_key": self.comm._bucket_key,
            "rank": self.rank, "world": self.world,
            "bucket_sizes": {int(b.index): int(b.size)
                             for b in self.buckets},
            "shards": {int(i): v.detach().cpu().numpy().copy()
                       for i, v in self._shards.items()},
        }
        if self.emulated:
            out["peer_shards"] = {
                int(i): {int(r): v.detach().cpu().numpy().copy()
                         for r, v in peers.items()}
                for i, peers in self._peer_shards.items()}
        return out

    def load_state_dict(self, state: dict, allow_reshard: bool = False):
        """Restore ``state_dict()`` output into this store, in place (the
        shards keep their tensors). The world size and the bucket layout
        must match; with ``allow_reshard`` a world-size change is
        resharded (``reshard.reshard_zero3_states``) when the state holds
        every rank's shards (the emulated layout)."""
        if int(state.get("world", self.world)) != self.world:
            if not allow_reshard:
                raise ValueError(
                    f"zero3 state world mismatch: checkpoint has "
                    f"{state.get('world')}, store runs {self.world}")
            from .reshard import reshard_zero3_states

            if not state.get("peer_shards"):
                raise ValueError(
                    f"zero3 state world mismatch (checkpoint "
                    f"{state.get('world')} vs live {self.world}) and this "
                    f"state holds only one rank's shards — reshard via "
                    f"CheckpointManager.load_sharded(allow_reshard=True), "
                    f"which joins all rank files")
            state = reshard_zero3_states([state], self.world)[0]
            state = {**state, "rank": self.rank,
                     "shards": {i: state["peer_shards"][i][self.rank]
                                if self.rank else v
                                for i, v in state["shards"].items()},
                     "peer_shards": _peers_of(state, self.rank,
                                              self.world)}
        key = state.get("bucket_key")
        if key is not None and self.comm._bucket_key is not None \
                and tuple(key) != tuple(self.comm._bucket_key):
            raise ValueError(
                "zero3 state bucket-key mismatch: the checkpointed bucket "
                "layout differs from this store's — resume with the same "
                "comm_buffer_size / parameter list")
        if not self.sharded:
            self.shard_()
        with torch.no_grad():
            for i, v in (state.get("shards") or {}).items():
                self._shards[int(i)].copy_(torch.as_tensor(np.asarray(v)))
            for i, peers in (state.get("peer_shards") or {}).items():
                for r, v in peers.items():
                    self._peer_shards[int(i)][int(r)].copy_(
                        torch.as_tensor(np.asarray(v)))
        for b in self.buckets:
            if self._state.get(b.index) == GATHERED:
                self.free_bucket(b.index)
        _m_param_bytes.set(self.param_bytes_per_rank())

    def meta_state(self) -> dict:
        """The layout's fingerprint, to refuse a resume whose sharding
        geometry changed."""
        return {"world": self.world, "rank": self.rank,
                "n_buckets": len(self.buckets),
                "bucket_key": self.comm._bucket_key}

    def check_meta(self, meta: dict, allow_world_drift: bool = False):
        if int(meta.get("world", self.world)) != self.world \
                and not allow_world_drift:
            raise ValueError(
                f"zero3 resume geometry mismatch: job_state world "
                f"{meta.get('world')} vs live {self.world} — pass "
                f"allow_reshard=True (restore_job_state) after "
                f"resharding the shard payloads to accept the drift")
        key = meta.get("bucket_key")
        if key is not None and self.comm._bucket_key is not None \
                and tuple(key) != tuple(self.comm._bucket_key):
            raise ValueError(
                "zero3 resume geometry mismatch: bucket layout changed "
                "between checkpoint and resume")

    def __repr__(self):
        return (f"Stage3ParamShards(rank={self.rank}/{self.world}, "
                f"buckets={len(self.buckets)}, sharded={self.sharded}, "
                f"resident={len(self.resident_buckets())})")


def _peers_of(state: dict, rank: int, world: int) -> dict:
    """An emulated state (rank 0's own shards and the peers') seen from
    ``rank``: every other rank's shards."""
    out = {}
    for i, own0 in state["shards"].items():
        every = [own0] + [state["peer_shards"][i][r]
                          for r in range(1, world)]
        out[i] = {r: every[r] for r in range(world) if r != rank}
    return out


# ---------------------------------------------------------------------------
# measurement helper
# ---------------------------------------------------------------------------

def _fake_params(shapes_dtypes, seed=0, device="cpu"):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
            .to(device, dt).requires_grad_() for shape, dt in shapes_dtypes]


def zero3_gather_report(params, config: Optional[GradCommConfig] = None,
                        world: int = 2, compute_s: float = 0.04,
                        seed: int = 0) -> dict:
    """Prefetched against synchronous exposed gather time of ``params``'
    shapes and dtypes, on detached fakes in an emulated store (the live
    model is not touched; the times are the host's assembly costs).
    ``compute_s`` is the emulated forward the prefetches run under,
    spread over the buckets."""
    config = config or GradCommConfig()
    shapes_dtypes = [(tuple(p.shape), p.dtype) for p in map(unwrap, params)
                     if p.requires_grad]

    store = Stage3ParamShards(_fake_params(shapes_dtypes, seed),
                              GradCommunicator(config), rank=0, world=world)
    store.shard_()
    per_bucket = []
    store.reset_exposed()
    for b in store.buckets:
        t0 = time.perf_counter()
        try:
            store.ensure_gathered(b.index)
            per_bucket.append({"bucket": b.index, "nbytes": int(b.nbytes),
                               "sync_ms": round(
                                   (time.perf_counter() - t0) * 1e3, 3)})
        finally:
            store.free_bucket(b.index)
    sync_exposed_ms = store.exposed_gather_s * 1e3
    bytes_per_rank = store.param_bytes_per_rank()
    param_bytes_full = int(store.stats["param_bytes_full"])
    n_buckets = len(store.buckets)

    store2 = Stage3ParamShards(_fake_params(shapes_dtypes, seed),
                               GradCommunicator(GradCommConfig(
                                   config.codec, config.comm_buffer_size,
                                   config.last_comm_buffer_size)),
                               rank=0, world=world)
    store2.shard_()
    store2.reset_exposed()
    per_layer = compute_s / max(1, n_buckets)
    for i, b in enumerate(store2.buckets):
        try:
            store2.ensure_gathered(b.index)
            if i + 1 < n_buckets:
                store2.prefetch_bucket(store2.buckets[i + 1].index)
            time.sleep(per_layer)
        finally:
            store2.free_bucket(b.index)
        for row in per_bucket:
            if row["bucket"] == b.index:
                row["prefetched"] = i > 0
    prefetch_exposed_ms = store2.exposed_gather_s * 1e3
    return {
        "world": int(world),
        "n_buckets": n_buckets,
        "param_bytes_full": param_bytes_full,
        "zero3_param_bytes_per_rank": int(bytes_per_rank),
        "sync_exposed_gather_ms": round(sync_exposed_ms, 3),
        "prefetch_exposed_gather_ms": round(prefetch_exposed_ms, 3),
        "emulated_forward_ms": round(compute_s * 1e3, 3),
        "per_bucket": per_bucket,
    }
