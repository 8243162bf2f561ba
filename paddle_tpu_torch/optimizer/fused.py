"""Fused flat-buffer optimizer updates over buckets (reference:
``paddle_tpu/optimizer/fused.py`` ``FusedFlatUpdater``: ``__init__``,
``_uniform_hypers``, ``_bucket_fn``, ``step``; the dequantizing update of
``paddle_tpu/jit/__init__.py`` ``_gc_fused_update``).

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

As in the reference, an optimizer with a ``grad_clip`` is refused: the
fused update does not clip. ``TrainStep`` clips the flat gradients
itself before it calls ``step()`` and says so (``caller_clips=True``).

``step_sharded`` (ZeRO) is not ported yet (ROADMAP Queue A 2, the ZeRO
remainder).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..distributed.grad_comm import build_buckets
from ..observability.metrics import get_registry as _get_registry
from ..ops.fused_update import (FUSED_RULES, BucketTable, WirePayload,
                                fused_dequant_update_buckets,
                                fused_update_buckets, rule_spec, slot_names)
from ..framework.autograd import unwrap
from .optimizer import lr_mult

__all__ = ["FusedFlatUpdater", "FUSABLE_OPTIMIZERS"]

# the rules with a fused kernel in the port
FUSABLE_OPTIMIZERS = tuple(FUSED_RULES)

_m_fused = _get_registry().counter(
    "fused_bucket_updates_total",
    help="optimizer updates applied as one fused kernel per bucket")


class FusedFlatUpdater:
    """Apply ``optimizer``'s update rule per flat bucket."""

    def __init__(self, optimizer, params, buckets=None, *,
                 caller_clips=False):
        kind = type(optimizer).__name__
        if kind not in FUSABLE_OPTIMIZERS:
            raise ValueError(f"{kind} has no fused flat update in the port; "
                             f"fusable: {FUSABLE_OPTIMIZERS}")
        if optimizer._grad_clip is not None and not caller_clips:
            raise ValueError(
                "fused flat updates do not implement grad_clip; clip the "
                "gradients before sync or use the per-param step()")
        self.optimizer = optimizer
        self.params = [t for t in map(unwrap, params) if t.requires_grad]
        self.buckets = (build_buckets(self.params) if buckets is None
                        else list(buckets))
        self._hypers = {b.index: self._uniform_hypers(b)
                        for b in self.buckets}
        self._rule = rule_spec(optimizer)    # (kind, hyper)
        self._slots: Dict[int, dict] = {}
        self._flat_p: Dict[int, torch.Tensor] = {}
        self._flat_g: Dict[int, torch.Tensor] = {}
        self._grad_views: Dict[int, List[torch.Tensor]] = {}
        self._table = None                   # BucketTable of the last step
        self._dequant_table = None           # ... of the last step_dequant
        self.table_builds = 0
        self._lr = None                      # (value, device, tensor)
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

    def _lay_out(self, bucket):
        """Flat parameter and gradient buffers for the bucket; parameters
        become views of the first. A one-parameter bucket is its own
        flat buffer."""
        ps = [self.params[pi] for pi in bucket.param_indices]
        dev = ps[0].device
        if len(ps) == 1 and ps[0].is_contiguous():
            flat = ps[0].data.view(-1)
        else:
            flat = torch.empty(bucket.size, dtype=bucket.dtype, device=dev)
            for p, view in zip(ps, self._views(bucket, flat)):
                view.copy_(p.data)
                p.data = view
        self._flat_p[bucket.index] = flat
        self._flat_g[bucket.index] = torch.zeros(bucket.size,
                                                 dtype=bucket.dtype,
                                                 device=dev)
        self._grad_views[bucket.index] = self._views(
            bucket, self._flat_g[bucket.index])

    def _init_flat_slots(self, bucket) -> dict:
        proto = self.optimizer._init_slots(
            torch.zeros(1, dtype=bucket.dtype,
                        device=self._flat_p[bucket.index].device))
        return {k: (v if v.dim() == 0 else
                    v.new_zeros(bucket.size)) for k, v in proto.items()}

    def _flat_grads(self, bucket) -> torch.Tensor:
        """The bucket's gradient as one flat tensor: the gradient buffer
        when every ``.grad`` is its view, else a concatenation."""
        flat = self._flat_g[bucket.index]
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
        ``attr``: the last one when no pointer moved, else a new one. The
        powers the launch reads are loaded from the slots when the slots
        do not hold the table's own views (a new table, the first step,
        or a step of the other form in between)."""
        kind, hyper = self._rule
        names = slot_names(kind)
        for b in self.buckets:
            if b.index not in self._slots:
                self._slots[b.index] = self._init_flat_slots(b)
        entries = [(self._flat_p[b.index], g,
                    [self._slots[b.index][nm] for nm in names],
                    self._hypers[b.index][1], self._hypers[b.index][0])
                   for b, g in zip(self.buckets, grads)]
        table = getattr(self, attr)
        if table is None or table.block_size != block_size \
                or table.key != BucketTable.pointers(entries):
            table = BucketTable(kind, hyper, entries, block_size=block_size)
            setattr(self, attr, table)
            self.table_builds += 1
        if table.adam:
            slots = [self._slots[b.index] for b in self.buckets]
            if any(s["beta1_pow"] is not a or s["beta2_pow"] is not c
                   for s, (a, c) in zip(slots, table.powers())):
                table.load_powers([(s["beta1_pow"], s["beta2_pow"])
                                   for s in slots])
        return table

    @torch.no_grad()
    def step(self):
        """One fused update of every bucket, in place: one
        ``fused_update_buckets`` launch on the card."""
        if not self.buckets:
            self.optimizer._accumulated_steps += 1
            return
        grads = [self._flat_grads(b) for b in self.buckets]
        table = self._bucket_table("_table", grads)
        fused_update_buckets(table, self._lr_tensor(table.device))
        self._stepped(table)

    def _stepped(self, table):
        if table.adam:
            for b, (b1p, b2p) in zip(self.buckets, table.powers()):
                self._slots[b.index].update(beta1_pow=b1p, beta2_pow=b2p)
        _m_fused.inc(len(self.buckets))
        self.optimizer._accumulated_steps += 1

    @torch.no_grad()
    def step_dequant(self, payloads, world: int, block_size: int):
        """One fused dequantize-and-update of every bucket, in place: one
        ``fused_dequant_update_buckets`` launch on the card.
        ``payloads[i]`` is bucket ``i``'s ``(q_sum, scales)``, the
        blockwise payload summed over ``world`` ranks (int32 or fp32
        carrier) and its per-block scales. The gradient buffers are not
        read: the kernel decodes ``q_sum * scale / world`` itself and
        rounds it to the bucket's dtype."""
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

    def __repr__(self):
        return (f"FusedFlatUpdater({type(self.optimizer).__name__}, "
                f"buckets={len(self.buckets)})")
