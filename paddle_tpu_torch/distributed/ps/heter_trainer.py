"""Training over the pass cache (reference:
``paddle_tpu/distributed/ps/heter_trainer.py``: ``heter_embedding``,
lines 27-73; ``HeterPassTrainer``, 76-131; ``CompiledPassStep``,
133-243).

``heter_embedding(cache, ids)`` is the eager lookup over a
``DevicePassCache``: a gather from the slab whose backward scatter-adds
the rows' gradient into the cache's ``gacc`` (pushed to the host table
at ``end_pass``), in place of a host push a step.
``HeterPassTrainer`` drives passes: the working set of a pass's batches
pulled once, a step function per batch, the pass synced back.

``CompiledPassStep`` is the pass step ``bench.py``'s ``widedeep`` mode
times. The reference compiles it into one XLA program; the port runs it
eagerly, every tensor on the cache's device:

1. the batch's slots (a host ``searchsorted``) and labels are uploaded
   through pinned memory without a wait;
2. the rows are gathered from the slab (``F.embedding``, whose backward
   sums duplicate ids by sorting them on the card, in a fixed order) and
   the model runs on them flattened to ``[batch, slots * dim]``;
3. ``loss_fn(output, labels)`` and autograd give the dense gradients, in
   the updater's flat buffers, and ``g_rows``, the slab's gradient;
4. the dense update is one ``fused_update_buckets`` launch over the
   model's parameters (``optimizer.FusedFlatUpdater``; the optimizer's
   lr read at each step);
5. the table rule over the whole slab, as the reference writes it:
   ``None`` adds ``g_rows`` to ``gacc`` (pushed at ``end_pass()``);
   ``"adagrad"`` does ``gacc += g * g; rows -= lr * g / sqrt(gacc +
   1e-8)``; ``"sgd"`` does ``rows -= lr * g``. With a table rule the pass
   ends with ``end_pass(assign=True)``. The device Adagrad is not the
   host table's (``g / (sqrt(G) + 1e-6)``, its ``G`` kept across
   passes): ``gacc`` starts at zero each pass, as in the reference
   (ROADMAP Queue C).

No step waits for the card: the loss comes back as a 0-dim tensor.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ...framework.device import to_device
from ...framework.numeric import sqrt_rn
from ...nn import functional as F
from ...optimizer import FusedFlatUpdater
from .heter_cache import DevicePassCache

__all__ = ["HeterPassTrainer", "heter_embedding", "CompiledPassStep",
           "TABLE_OPTIMIZERS"]

TABLE_OPTIMIZERS = (None, "adagrad", "sgd")


class _CacheGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, cache, slot_idx):
        ctx.cache, ctx.slot_idx = cache, slot_idx
        return cache.lookup_slots(slot_idx)

    @staticmethod
    def backward(ctx, grad):
        ctx.cache._push_slot_grads(ctx.slot_idx.reshape(-1),
                                   grad.reshape(ctx.slot_idx.numel(), -1))
        return None, None, None


def heter_embedding(cache, ids):
    """``[*ids.shape, dim]`` rows of a ``DevicePassCache``; with grad
    enabled, the backward adds their gradient into the cache's ``gacc``."""
    if not isinstance(cache, DevicePassCache):
        raise NotImplementedError(
            f"heter_embedding over {type(cache).__name__}: only the pass "
            f"cache is ported (HeterCache: ROADMAP Queue A, 'the PS "
            f"remainder')")
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    slot_idx = cache.device_slots(np.asarray(ids))
    if not torch.is_grad_enabled():
        return cache.lookup_slots(slot_idx)
    anchor = torch.empty(0, device=cache.device, requires_grad=True)
    return _CacheGather.apply(anchor, cache, slot_idx)


class HeterPassTrainer:
    """Passes over a dataset: the union of a pass's sparse ids pulled in
    one call, ``step_fn(cache, batch)`` per batch, the pass synced back
    (values when the step function trains the rows on the device, else
    the merged gradients)."""

    def __init__(self, client, table_id: int, lr: float = -1.0,
                 sparse_slots: Sequence[int] = (0,), device="cuda"):
        self.cache = DevicePassCache(client, table_id, lr=lr, device=device)
        self.sparse_slots = tuple(sparse_slots)

    def _pass_ids(self, batches):
        return np.concatenate(
            [np.asarray(b[s], np.uint64).reshape(-1)
             for b in batches for s in self.sparse_slots])

    def train_from_dataset(self, dataset, step_fn: Callable, passes: int = 1,
                           pad_to=None):
        """``passes`` passes over ``dataset.iterate()``; returns the last
        pass's step outputs."""
        assign = bool(getattr(step_fn, "table_optimizer", None))
        outs = []
        for _ in range(int(passes)):
            batches = list(dataset.iterate())
            if not batches:
                return outs
            self.cache.begin_pass(self._pass_ids(batches), pad_to=pad_to)
            try:
                outs = [step_fn(self.cache, b) for b in batches]
            finally:
                self.cache.end_pass(assign=assign)
        return outs

    def infer_from_dataset(self, dataset, step_fn: Callable):
        """One pass of ``step_fn`` with nothing pushed back."""
        batches = list(dataset.iterate())
        if not batches:
            return []
        self.cache.begin_pass(self._pass_ids(batches))
        try:
            return [step_fn(self.cache, b) for b in batches]
        finally:
            self.cache.end_pass()


class CompiledPassStep:
    """One training step over the pass cache (see the module docstring).

        step = CompiledPassStep(cache, model, optimizer, loss_fn,
                                table_optimizer="adagrad", table_lr=0.1)
        cache.begin_pass(pass_ids, pad_to=vocab)
        for batch in pass_batches:
            loss = step(cache, batch)       # (ids, labels) numpy
        cache.end_pass(assign=True)

    ``loss_fn(output, labels) -> 0-dim tensor``. The model's parameters
    are laid out flat by the updater at construction (each becomes a
    view of its bucket)."""

    def __init__(self, cache: DevicePassCache, model, optimizer, loss_fn,
                 table_optimizer=None, table_lr=0.1):
        if table_optimizer not in TABLE_OPTIMIZERS:
            raise ValueError(f"table_optimizer {table_optimizer!r}: one of "
                             f"{TABLE_OPTIMIZERS}")
        self.cache = cache
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.table_optimizer = table_optimizer
        self.table_lr = float(table_lr)
        self.updater = FusedFlatUpdater(optimizer, model.parameters())

    def __call__(self, cache: DevicePassCache, batch):
        """``batch``: (ids ``[batch, slots]``, labels) numpy. Returns the
        loss, a 0-dim fp32 tensor on the cache's device."""
        ids, labels = batch[0], batch[1]
        slots = cache.device_slots(ids)
        y = to_device(labels, cache.device, torch.float32)
        rows = cache._rows
        self.updater.zero_grad()
        rows.requires_grad_(True)
        try:
            emb = F.embedding(slots, rows)
            out = self.model(emb.reshape(slots.shape[0], -1))
            loss = self.loss_fn(out, y).to(torch.float32)
            loss.backward()
        finally:
            rows.requires_grad_(False)
        g, rows.grad = rows.grad, None
        self.updater.step()
        with torch.no_grad():
            self._table_rule(cache, rows, g)
        return loss.detach()

    def _table_rule(self, cache, rows, g) -> None:
        if self.table_optimizer is None:
            cache._gacc.add_(g)
        elif self.table_optimizer == "adagrad":
            cache._gacc.add_(g * g)
            rows.sub_(self.table_lr * g / sqrt_rn(cache._gacc + 1e-8))
        else:
            rows.sub_(self.table_lr * g)
