"""Fused flat-buffer optimizer updates over buckets (reference:
``paddle_tpu/optimizer/fused.py`` ``FusedFlatUpdater``, the whole class;
the dequantizing update of ``paddle_tpu/jit/__init__.py``
``_gc_fused_update``).

    fused = FusedFlatUpdater(optimizer, model.parameters())
    fused.zero_grad()
    loss.backward()
    fused.step()            # one fused_update_buckets kernel, all buckets

    # data parallel on the quantized gradient wire: the buckets' summed
    # payloads (GradCommunicator.reduce_bucket_payload) go in instead of
    # the gradients, one fused_dequant_update_buckets kernel for all
    fused.step_dequant(payloads, world, block_size)

The update rules are elementwise, so one kernel over a bucket's flat
buffer equals the per-parameter updates. The reference runs one kernel
per bucket; the port runs one launch a step over a table of all the
buckets (``ops/fused_update.py`` ``BucketTable``), built at the first
step and rebuilt only when a pointer in it changes, which is the
``torch.cat`` fallback below. ``step_dequant`` keeps a table of its own,
whose entries carry the payloads; the communicator writes them into the
same buffers every step, so that table too is built once.
``table_builds`` counts the tables built. Where the reference
concatenates each bucket's parameters and gradients every step and
scatters the new values back, the port lays them out flat once: at
construction each multi-parameter bucket gets one flat parameter buffer
and one flat gradient buffer, and every parameter's ``.data`` becomes a
view of the first. ``zero_grad()`` zeroes the gradient buffers and
points every ``.grad`` at its view, so ``backward()`` accumulates into
them in place; ``step()`` then updates the flat buffers in place with
no copy. A ``.grad`` that is not its view at step time (``backward()``
without ``zero_grad()`` first) is gathered with one ``torch.cat``.

Slots are flat per bucket (moments laid out like the bucket); the
scalar slots (beta powers) are one 0-dim tensor per bucket, exact
because every parameter starts from the same value and steps with the
same betas. After ``step()`` they are views into the table's power
buffers, which the kernel steps on the card; the buffers alternate, so
a view is valid until the step after next (``_slots`` always holds the
current ones).

The learning rate is read from the optimizer at every step
(``get_lr()``, a float or an ``LRScheduler``'s current value) and goes
to the launch as a 0-dim fp32 tensor on the card, kept while the value
stays and made anew when it moves; it is not part of the table, so a
schedule never rebuilds one.

The reference's ``FUSABLE_OPTIMIZERS`` are taken: the four rules with
a kernel, and Adagrad, Adadelta, Adamax and RMSProp, which have none
there either (the reference runs their jnp rule over each flat bucket):
``step()`` runs their PyTorch rule (``Optimizer._update``) over each
flat bucket, in place, bucket by bucket. Lamb, Lars and DGCMomentum are
refused with the reference's message: their per-parameter norms and
top-k would change meaning over a bucket.

The optimizer's ``state_dict()`` reads each parameter's slots out of
the flat buckets after a step here; slots written to the optimizer
after that (its own ``step()``, ``set_state_dict``) are copied into the
flat buckets, in place, before the next step (the last writer wins).

As in the reference, an optimizer with a ``grad_clip`` is refused: the
fused update does not clip. ``TrainStep`` clips the flat gradients
itself before it calls ``step()`` and says so (``caller_clips=True``).

``PerParameterUpdater`` is the same surface for the three rules that
cannot run over a bucket (Lamb, Lars, DGCMomentum): each parameter its
own one-parameter "bucket", its ``.grad`` read in place, and ``step()``
the optimizer's ``_update`` parameter by parameter, as the reference's
compiled ``TrainStep`` updates every parameter (``opt._update``,
``paddle_tpu/jit/__init__.py:903``). ``jit.TrainStep`` takes it for
those three and ``FusedFlatUpdater`` for the rest.

ZeRO (``step_sharded``, arXiv 2004.13336): after a reduce_scatter sync
each rank owns ``[rank * chunk, (rank + 1) * chunk)`` of every bucket,
``chunk = ceil(size / world)``; the update runs on that owned shard
only, with slots of ``chunk`` elements (1/world of stage 1's). So that a
shard is a contiguous view, the flat parameter and gradient buffers are
laid out padded to ``world * chunk`` (``world=`` at construction, or at
the first ``step_sharded``, which lays them out again once); the
parameters and ``.grad`` views are their first ``size`` elements. One
``step_sharded`` is one ``fused_update_buckets`` launch over a table of
the owned shards (a shard is a pointer and a length; the kernel is
unchanged, so on the card each shard must start 16-byte aligned, which
holds when ``chunk`` is a multiple of 4 fp32 elements, as at GPT's
widths). Stage 2 then re-assembles each bucket's parameter with one
``all_gather`` of the shards. Stage 3 (``param_store=``, a
``distributed.sharding.Stage3ParamShards``) updates the store's own
at-rest shard in place and commits it, with no gather; the updater's
flat parameter buffers are dropped (``release_param_buffers``), so the
full parameters are never resident for the update. With no process
group of ``world`` ranks (one process emulating them, as in the
reference's tests) the table also holds the other ranks' shards, each
with its own slots, so the emulated world steps as the real one would.
``step(futures=...)`` takes ``OverlappedGradCommunicator.sync_async``'s
futures: each reduced flat gradient is copied into its bucket's gradient
buffer (the table's pointers hold) and its residual committed to the
communicator.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import torch

from ..distributed import collective as _coll
from ..distributed.grad_comm import GradBucket, build_buckets
from ..observability.metrics import get_registry as _get_registry
from ..ops.fused_update import (BucketTable, WirePayload,
                                fused_dequant_update_buckets,
                                fused_update_buckets, rule_spec, slot_names)
from ..framework.autograd import unwrap
from ..framework.grads import clear_grad
from .optimizer import lr_mult

__all__ = ["FusedFlatUpdater", "PerParameterUpdater", "FUSABLE_OPTIMIZERS",
           "UNFUSABLE_OPTIMIZERS"]

# elementwise update rules: over a flat bucket they are the per-parameter
# update (the fused rules run the kernel, the others their PyTorch rule)
FUSABLE_OPTIMIZERS = ("SGD", "Momentum", "Adagrad", "Adadelta", "Adam",
                      "AdamW", "Adamax", "RMSProp")
# per-parameter norm / top-k rules: over a bucket they would change
UNFUSABLE_OPTIMIZERS = ("Lamb", "Lars", "DGCMomentum")

_m_fused = _get_registry().counter(
    "fused_bucket_updates_total",
    help="optimizer updates applied as one fused kernel per bucket")


class FusedFlatUpdater:
    """Apply ``optimizer``'s update rule per flat bucket."""

    def __init__(self, optimizer, params, buckets=None, *,
                 caller_clips=False, communicator=None, world: int = 1):
        kind = type(optimizer).__name__
        if kind in UNFUSABLE_OPTIMIZERS or kind not in FUSABLE_OPTIMIZERS:
            raise ValueError(
                f"{kind} cannot be fused over flat buckets (its update "
                f"uses per-parameter norms/top-k); fusable: "
                f"{FUSABLE_OPTIMIZERS}")
        if optimizer._grad_clip is not None and not caller_clips:
            raise ValueError(
                "fused flat updates do not implement grad_clip; clip the "
                "gradients before sync or use the per-param step()")
        self.optimizer = optimizer
        self.params = [t for t in map(unwrap, params) if t.requires_grad]
        self.communicator = communicator
        if buckets is None:
            buckets = (build_buckets(self.params) if communicator is None
                       else communicator.buckets_for(self.params))
        self.buckets = list(buckets)
        self._hypers = {b.index: self._uniform_hypers(b)
                        for b in self.buckets}
        self._rule = rule_spec(optimizer)    # (kind, hyper)
        self._slots: Dict[int, dict] = {}
        self._flat_p: Dict[int, torch.Tensor] = {}
        self._flat_g: Dict[int, torch.Tensor] = {}
        self._grad_views: Dict[int, List[torch.Tensor]] = {}
        self._table = None                   # BucketTable of the last step
        self._dequant_table = None           # ... of the last step_dequant
        self._shard_table = None             # ... of the last step_sharded
        self.table_builds = 0
        self._lr = None                      # (value, device, tensor)
        # ZeRO: this rank's shard slots, and the emulated other ranks'
        self._shard_slots: Dict[int, dict] = {}
        self._peer_slots: Dict[tuple, dict] = {}
        self._world = max(1, int(world))     # the buffers' padding world
        with torch.no_grad():
            for b in self.buckets:
                self._lay_out(b)

    # ------------------------------------------------------------ plumbing
    def _uniform_hypers(self, bucket) -> tuple:
        """(lr_mult, wd) of the bucket — uniform across its parameters
        (the kernel applies one scalar pair)."""
        lms, wds = set(), set()
        for pi in bucket.param_indices:
            p = self.params[pi]
            lms.add(lr_mult(p))
            wds.add(float(self.optimizer._param_wd(p)))
        if len(lms) > 1 or len(wds) > 1:
            raise ValueError(
                f"bucket {bucket.index} mixes per-param hyperparameters "
                f"(lr_mult {sorted(lms)}, weight_decay {sorted(wds)}); "
                f"group the parameters by (lr_mult, wd) before bucketing "
                f"(TrainStep does)")
        return lms.pop(), wds.pop()

    def _views(self, bucket, flat):
        return [flat[off:off + n].view(shape) for off, n, shape in
                zip(bucket.offsets, bucket.numels, bucket.shapes)]

    def _chunk(self, bucket) -> int:
        """Elements of a rank's shard: ceil(size / world)."""
        return -(-bucket.size // self._world)

    def _lay_out(self, bucket, params=True):
        """Flat parameter and gradient buffers for the bucket, each padded
        to ``world * chunk`` elements; parameters become views of the
        first. An unpadded one-parameter bucket is its own flat buffer.
        ``params=False`` lays out the gradient buffer only."""
        ps = [self.params[pi] for pi in bucket.param_indices]
        dev = ps[0].device
        padded = self._world * self._chunk(bucket)
        if params:
            if len(ps) == 1 and ps[0].is_contiguous() \
                    and padded == bucket.size:
                flat = ps[0].data.view(-1)
            else:
                flat = torch.zeros(padded, dtype=bucket.dtype, device=dev)
                for p, view in zip(ps, self._views(bucket, flat)):
                    view.copy_(p.data)
                    p.data = view
            self._flat_p[bucket.index] = flat
        self._flat_g[bucket.index] = torch.zeros(padded, dtype=bucket.dtype,
                                                 device=dev)
        self._grad_views[bucket.index] = self._views(
            bucket, self._flat_g[bucket.index])

    def release_param_buffers(self):
        """Drop the flat parameter buffers (ZeRO stage 3: the at-rest
        store holds the parameters, and ``step_sharded(param_store=)``
        updates its shards; ``step()`` can no longer run)."""
        self._flat_p = {}

    def _flat_param(self, bucket) -> torch.Tensor:
        return self._flat_p[bucket.index][:bucket.size]

    def _init_flat_slots(self, bucket, numel=None) -> dict:
        """Slots laid out like the bucket (or a shard of ``numel``)."""
        n = bucket.size if numel is None else numel
        proto = self.optimizer._init_slots(
            torch.zeros(1, dtype=bucket.dtype,
                        device=self._flat_g[bucket.index].device))
        return {k: (v if v.dim() == 0 else v.expand(n).clone())
                for k, v in proto.items()}

    def _flat_grads(self, bucket) -> torch.Tensor:
        """The bucket's gradient as one flat tensor: the gradient buffer
        when every ``.grad`` is its view, else a concatenation."""
        flat = self._flat_g[bucket.index][:bucket.size]
        views = self._grad_views[bucket.index]
        grads = [self.params[pi].grad for pi in bucket.param_indices]
        if any(g is None for g in grads):
            raise RuntimeError(f"bucket {bucket.index}: a parameter has no "
                               f"gradient")
        if all(g is v or (g.data_ptr() == v.data_ptr()
                          and g.shape == v.shape)
               for g, v in zip(grads, views)):
            return flat
        return torch.cat([g.reshape(-1) for g in grads]).to(bucket.dtype)

    def flat_grads(self) -> List[torch.Tensor]:
        """Every bucket's flat gradient, in bucket order."""
        return [self._flat_grads(b) for b in self.buckets]

    def _lr_tensor(self, device) -> torch.Tensor:
        """This step's learning rate on ``device``: the kept tensor while
        the optimizer's value and the device are the same, else a new
        one (a tensor is never written after it is made, so a launch
        still queued reads the rate of its own step)."""
        lr = self.optimizer.get_lr()
        if self._lr is None or self._lr[:2] != (lr, device):
            self._lr = (lr, device, self.optimizer._lr_tensor(device))
        return self._lr[2]

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def zero_grad(self):
        """Zero the gradient buffers and point every ``.grad`` at its view,
        so the next ``backward()`` accumulates into the buffers."""
        for b in self.buckets:
            self._flat_g[b.index].zero_()
            for pi, view in zip(b.param_indices, self._grad_views[b.index]):
                self.params[pi].grad = view

    def _bucket_table(self, attr: str, grads, block_size=None
                      ) -> BucketTable:
        """The table of this step's tensors (``grads``: each bucket's
        gradient, or its ``WirePayload`` with ``block_size``), kept in
        ``attr`` (``_table_of``)."""
        self._ensure_slots()
        return self._table_of(attr, [
            (self._flat_param(b), g, self._slots[b.index],
             self._hypers[b.index]) for b, g in zip(self.buckets, grads)],
            block_size)

    def _table_of(self, attr: str, items, block_size=None) -> BucketTable:
        """The table of ``items`` (``(p, g, slot dict, (lm, wd))`` an
        entry), kept in ``attr``: the last one when no pointer moved,
        else a new one. The powers the launch reads are loaded from the
        slot dicts when they do not hold the table's own views (a new
        table, the first step, or a step of another form in between)."""
        kind, hyper = self._rule
        names = slot_names(kind)
        entries = [(p, g, [s[nm] for nm in names], h[1], h[0])
                   for p, g, s, h in items]
        table = getattr(self, attr)
        if table is None or table.block_size != block_size \
                or table.key != BucketTable.pointers(entries):
            table = BucketTable(kind, hyper, entries, block_size=block_size)
            setattr(self, attr, table)
            self.table_builds += 1
        if table.adam:
            slots = [s for _, _, s, _ in items]
            if any(s["beta1_pow"] is not a or s["beta2_pow"] is not c
                   for s, (a, c) in zip(slots, table.powers())):
                table.load_powers([(s["beta1_pow"], s["beta2_pow"])
                                   for s in slots])
        return table

    def _ensure_slots(self):
        """Every bucket's flat slots, made at the first step; the
        optimizer's per-parameter slots copied in when it wrote them
        last."""
        for b in self.buckets:
            if b.index not in self._slots:
                self._slots[b.index] = self._init_flat_slots(b)
        if self.optimizer._slot_writer != "eager":
            return
        own = self.optimizer._slots
        for b in self.buckets:
            flat = self._slots[b.index]
            for pi, off, n in zip(b.param_indices, b.offsets, b.numels):
                s = own.get(id(self.params[pi]))
                for k, v in (s or {}).items():
                    if flat[k].dim() == 0:
                        flat[k] = v.detach().to(flat[k].device,
                                                torch.float32).clone()
                    else:
                        flat[k][off:off + n].copy_(v.reshape(-1))
        self.optimizer._slot_writer = weakref.ref(self)

    @torch.no_grad()
    def step(self, futures=None):
        """One update of every bucket, in place: one
        ``fused_update_buckets`` launch on the card for a rule with a
        kernel, else the rule bucket by bucket. ``futures``
        (``sync_async``'s) supply reduced flat gradients, copied into the
        gradient buffers, and residuals for the communicator."""
        if not self.buckets:
            self.optimizer._accumulated_steps += 1
            return
        for fut in futures or ():
            b = fut.bucket
            self._flat_g[b.index][:b.size].copy_(fut.wait())
            for pi, view in zip(b.param_indices, self._grad_views[b.index]):
                self.params[pi].grad = view
            if fut.residual is not None and self.communicator is not None:
                self.communicator._residuals[b.index] = fut.residual
        grads = [self._flat_grads(b) for b in self.buckets]
        if self._rule is None:
            self._step_rule(grads)
            return
        table = self._bucket_table("_table", grads)
        fused_update_buckets(table, self._lr_tensor(table.device))
        self._stepped(table)

    def _step_rule(self, grads):
        """The optimizer's ``_update`` over each flat bucket (a rule
        without a kernel)."""
        self._ensure_slots()
        opt = self.optimizer
        for b, g in zip(self.buckets, grads):
            flat = self._flat_param(b)
            lm, wd = self._hypers[b.index]
            new_p, new_s = opt._update(flat, g.to(flat.dtype),
                                       self._slots[b.index],
                                       self._lr_tensor(flat.device), lm, wd)
            flat.copy_(new_p)
            self._slots[b.index] = new_s
        self._stepped(None)

    def _stepped(self, table, slot_dicts=None):
        if table is not None and table.adam:
            if slot_dicts is None:
                slot_dicts = [self._slots[b.index] for b in self.buckets]
            for s, (b1p, b2p) in zip(slot_dicts, table.powers()):
                s.update(beta1_pow=b1p, beta2_pow=b2p)
        _m_fused.inc(len(self.buckets))
        self.optimizer._accumulated_steps += 1
        self.optimizer._slot_writer = weakref.ref(self)

    @torch.no_grad()
    def step_dequant(self, payloads, world: int, block_size: int):
        """One fused dequantize-and-update of every bucket, in place: one
        ``fused_dequant_update_buckets`` launch on the card.
        ``payloads[i]`` is bucket ``i``'s ``(q_sum, scales)``, the
        blockwise payload summed over ``world`` ranks (int32 or fp32
        carrier) and its per-block scales. The gradient buffers are not
        read: the kernel decodes ``q_sum * scale / world`` itself and
        rounds it to the bucket's dtype."""
        if self._rule is None:
            raise ValueError(
                f"{type(self.optimizer).__name__} has no dequantizing "
                f"kernel: decode the payloads and call step()")
        if len(payloads) != len(self.buckets):
            raise ValueError(f"{len(payloads)} payloads for "
                             f"{len(self.buckets)} buckets")
        if not self.buckets:
            self.optimizer._accumulated_steps += 1
            return
        wire = [WirePayload(q_sum, scales, None, b.dtype)
                for b, (q_sum, scales) in zip(self.buckets, payloads)]
        table = self._bucket_table("_dequant_table", wire, block_size)
        fused_dequant_update_buckets(table, self._lr_tensor(table.device),
                                     world)
        self._stepped(table)

    # ------------------------------------------------------------- ZeRO-2/3
    def _relay(self, world: int, params: bool = True):
        """Lay the flat buffers out again, padded for ``world`` (their
        contents kept; the parameters and ``.grad`` views follow)."""
        old_p, old_g = dict(self._flat_p), dict(self._flat_g)
        self._world = int(world)
        for b in self.buckets:
            self._lay_out(b, params=params and b.index in old_p)
            self._flat_g[b.index][:b.size].copy_(old_g[b.index][:b.size])
            for pi, view in zip(b.param_indices, self._grad_views[b.index]):
                if self.params[pi].grad is not None:
                    self.params[pi].grad = view
        del old_p, old_g

    @torch.no_grad()
    def step_sharded(self, rank: int, world: int, flat_grad_shards=None,
                     group=None, param_store=None):
        """ZeRO stage 2 (or 3 with ``param_store``): the update of this
        rank's owned shard of every bucket, one ``fused_update_buckets``
        launch (module docstring). ``flat_grad_shards`` maps a bucket
        index to this rank's reduced gradient shard; without an entry
        the shard is sliced from the bucket's gradient buffer, which the
        reduce_scatter sync wrote. Stage 2 then all-gathers each
        bucket's parameter; stage 3 commits the shard to the store."""
        world, rank = int(world), int(rank)
        if world <= 1:
            return self.step()
        if self._world != world:
            self._relay(world, params=param_store is None)
        if not self.buckets:
            self.optimizer._accumulated_steps += 1
            return
        group = group if param_store is None else param_store.group
        emulated = _coll._nranks(group) < world
        if param_store is not None:
            self.release_param_buffers()
            ranks = [rank] + (param_store.peer_ranks()
                              if param_store.emulated else [])
        else:
            ranks = range(world) if emulated else [rank]
        flat_grad_shards = flat_grad_shards or {}
        items, slot_dicts = [], []
        for b in self.buckets:
            chunk = self._chunk(b)
            for r in ranks:
                lo = r * chunk
                g = flat_grad_shards.get(b.index) if r == rank else None
                if g is None:
                    g = self._flat_g[b.index][lo:lo + chunk]
                if param_store is None:
                    p = self._flat_p[b.index][lo:lo + chunk]
                elif r == rank:
                    p = param_store.own_shard(b.index)
                else:
                    p = param_store.peer_shard(b.index, r)
                key = b.index if r == rank else (b.index, r)
                store = self._shard_slots if r == rank else self._peer_slots
                if key not in store:
                    store[key] = self._init_flat_slots(b, numel=chunk)
                items.append((p, g.to(p.dtype), store[key],
                              self._hypers[b.index]))
                slot_dicts.append(store[key])
        if self._rule is None:
            opt = self.optimizer
            for p, g, s, (lm, wd) in items:
                new_p, new_s = opt._update(p, g, s,
                                           self._lr_tensor(p.device), lm, wd)
                p.copy_(new_p)
                s.update(new_s)
            table = None
        else:
            table = self._table_of("_shard_table", items)
            fused_update_buckets(table, self._lr_tensor(table.device))
        self._stepped(table, slot_dicts)
        for b in self.buckets:
            chunk = self._chunk(b)
            if param_store is not None:
                param_store.commit_shard(b.index,
                                         param_store.own_shard(b.index))
                for r in ranks[1:]:
                    param_store.commit_peer_shard(
                        b.index, r, param_store.peer_shard(b.index, r))
            elif not emulated:
                # re-assemble the updated parameter from every rank's shard
                flat = self._flat_p[b.index]
                flat.copy_(_coll.all_gather(
                    None, flat[rank * chunk:(rank + 1) * chunk],
                    group=group).reshape(-1))

    # ------------------------------------------------------------ state io
    def shard_slots_state(self) -> dict:
        """The ZeRO shard slots (``step_sharded``'s; the optimizer's
        per-parameter state never sees them) as numpy, scalar slots as
        floats, with the unpadded bucket sizes a reshard needs."""
        def host(slots):
            return {k: (float(v) if v.dim() == 0 else
                        v.detach().cpu().numpy().copy())
                    for k, v in slots.items()}

        return {
            "own": {int(i): host(s) for i, s in self._shard_slots.items()},
            "peer": {(int(i), int(r)): host(s)
                     for (i, r), s in self._peer_slots.items()},
            "bucket_sizes": {int(b.index): int(b.size)
                             for b in self.buckets},
        }

    def load_shard_slots_state(self, state: dict):
        """Inverse of ``shard_slots_state()``: the slots on the gradient
        buffers' device."""
        dev = next(iter(self._flat_g.values())).device if self._flat_g \
            else torch.device("cpu")

        def dev_slots(s):
            return {k: torch.as_tensor(v, dtype=torch.float32
                                       if isinstance(v, float) else None
                                       ).to(dev).clone()
                    for k, v in s.items()}

        self._shard_slots = {int(i): dev_slots(s) for i, s in
                             (state.get("own") or {}).items()}
        self._peer_slots = {(int(i), int(r)): dev_slots(s) for (i, r), s in
                            (state.get("peer") or {}).items()}
        self._shard_table = None

    def sync_slots_to_optimizer(self):
        """Each parameter's slots, views of the flat buckets' (a 0-dim
        slot the bucket's), into the optimizer's own, so its
        ``state_dict()`` sees the fused state."""
        for b in self.buckets:
            slots = self._slots.get(b.index)
            if slots is None:
                continue
            for pi, off, n, shape in zip(b.param_indices, b.offsets,
                                         b.numels, b.shapes):
                self.optimizer._slots[id(self.params[pi])] = {
                    k: v if v.dim() == 0 else v[off:off + n].view(shape)
                    for k, v in slots.items()}

    def load_slots_from_optimizer(self):
        """Flat bucket slots from the optimizer's per-parameter ones
        (after a restore); a parameter without saved slots gets its
        initial values."""
        for b in self.buckets:
            if b.index not in self._slots:
                self._slots[b.index] = self._init_flat_slots(b)
        own = self.optimizer._slots
        for b in self.buckets:
            flat = self._slots[b.index]
            for pi, off, n in zip(b.param_indices, b.offsets, b.numels):
                p = self.params[pi]
                s = own.get(id(p)) or self.optimizer._init_slots(p.detach())
                for k, v in s.items():
                    if flat[k].dim() == 0:
                        flat[k] = v.detach().to(flat[k].device,
                                                torch.float32).clone()
                    else:
                        flat[k][off:off + n].copy_(v.reshape(-1))
        self.optimizer._slot_writer = weakref.ref(self)

    def __repr__(self):
        return (f"FusedFlatUpdater({type(self.optimizer).__name__}, "
                f"buckets={len(self.buckets)})")


class PerParameterUpdater:
    """``FusedFlatUpdater``'s surface for ``TrainStep`` over a rule that
    needs its parameters whole (module docstring): ``buckets`` one a
    parameter, ``flat_grads()`` flat views of the ``.grad`` tensors (a
    clip or an accumulation writes them in place), ``step()`` the rule
    parameter by parameter through ``Optimizer._step_plain``, on the CPU
    and on the card alike."""

    def __init__(self, optimizer, params):
        self.optimizer = optimizer
        self.params = [t for t in map(unwrap, params) if t.requires_grad]
        self.buckets = []
        for i, p in enumerate(self.params):
            b = GradBucket(i, p.dtype)
            b.add(i, tuple(p.shape))
            self.buckets.append(b)

    def zero_grad(self):
        for p in self.params:
            clear_grad(p)

    def flat_grads(self) -> List[torch.Tensor]:
        for i, p in enumerate(self.params):
            if p.grad is None:
                raise RuntimeError(f"parameter {i} has no gradient")
        return [p.grad.view(-1) for p in self.params]

    @torch.no_grad()
    def step(self):
        opt = self.optimizer
        opt._step_plain(self.params, [p.grad.to(p.dtype)
                                      for p in self.params])
        opt._accumulated_steps += 1
        opt._slot_writer = "eager"

    def __repr__(self):
        return (f"PerParameterUpdater({type(self.optimizer).__name__}, "
                f"params={len(self.params)})")
