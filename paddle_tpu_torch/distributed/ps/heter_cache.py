"""The pass cache: a training pass's sparse rows on the card (reference:
``paddle_tpu/distributed/ps/heter_cache.py`` ``DevicePassCache``, lines
56-151).

Before a pass, ``begin_pass`` pulls the pass's working set (the unique
ids of all its batches) from the host table in one call, pads it to
``pad_to`` rows and uploads it as one ``[rows, dim]`` fp32 slab, with a
zero gradient accumulator ``gacc`` of the same shape. In the pass, a
lookup is a gather from the slab and a gradient is a scatter-add into
``gacc``; the id -> slot map is a host ``searchsorted`` over the sorted
keys (``slots``), which raises ``KeyError`` for an id outside the pass.
``end_pass`` syncs the pass back: ``assign=False`` pushes the merged
gradient of every row that has one (one optimizer step a pass a key on
the host), ``assign=True`` writes the rows' values back (when a device
optimizer has trained them, ``heter_trainer.CompiledPassStep``).

The slab and ``gacc`` live on the cache's device: CUDA unless the cache
is made with ``device="cpu"``. The upload goes through pinned memory
without a wait (``framework/device.py`` ``to_device``); ``end_pass``
waits for the card once, for the download.

The capacity-bounded LRU/LFU tier (the reference's ``HeterCache``,
lines 154-461) is not on ``bench.py``'s path and is not ported (ROADMAP
Queue A, "the PS remainder").
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...framework.device import resolve_device, to_device

__all__ = ["DevicePassCache"]


class DevicePassCache:
    def __init__(self, client, table_id: int, lr: float = -1.0,
                 device="cuda"):
        self.client = client
        self.table_id = int(table_id)
        self.lr = float(lr)
        self.device = resolve_device(device)
        self._keys: Optional[np.ndarray] = None
        self._n_real = 0
        self._rows: Optional[torch.Tensor] = None    # [rows, dim]
        self._gacc: Optional[torch.Tensor] = None    # [rows, dim]
        self.pulls = 0        # host-table round trips
        self.pushes = 0

    def begin_pass(self, all_ids, pad_to=None):
        """Pull the pass's unique ids in one call; the slab padded with
        zero rows to ``pad_to`` (a fixed size across passes)."""
        keys = np.unique(np.asarray(all_ids, np.uint64).reshape(-1))
        rows = np.asarray(self.client.pull(self.table_id, keys))
        self.pulls += 1
        self._n_real = len(keys)
        if pad_to is not None and pad_to > len(keys):
            rows = np.pad(rows, ((0, pad_to - len(keys)), (0, 0)))
        self._keys = keys
        self._rows = to_device(rows, self.device, torch.float32)
        self._gacc = torch.zeros_like(self._rows)
        return self

    def slots(self, ids) -> np.ndarray:
        """The slab row of each id (int32, ``ids``' shape), by a binary
        search over the pass's sorted keys."""
        if self._keys is None:
            raise RuntimeError("begin_pass() first")
        flat = np.asarray(ids, np.uint64).reshape(-1)
        idx = np.searchsorted(self._keys, flat)
        idx_c = np.minimum(idx, self._keys.size - 1)
        bad = self._keys[idx_c] != flat
        if bad.any():
            raise KeyError(
                f"id {int(flat[bad][0])} not in this pass's working set; "
                f"include it in begin_pass(all_ids)")
        return idx.astype(np.int32).reshape(np.shape(ids))

    def device_slots(self, ids) -> torch.Tensor:
        """``slots(ids)`` as an int64 tensor on the cache's device,
        uploaded without a wait."""
        return to_device(self.slots(ids), self.device, torch.int64)

    def lookup(self, ids) -> torch.Tensor:
        """``[*ids.shape, dim]``: a gather from the slab."""
        return self.lookup_slots(self.device_slots(ids))

    def lookup_slots(self, slot_idx: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.embedding(slot_idx, self._rows)

    def push_grads(self, ids, grads):
        """Add ``grads`` (one row per id) into ``gacc``; a duplicate id
        sums."""
        self._push_slot_grads(self.device_slots(ids).reshape(-1), grads)

    def _push_slot_grads(self, slot_idx: torch.Tensor, grads) -> None:
        g = (grads if isinstance(grads, torch.Tensor)
             else torch.as_tensor(np.asarray(grads, np.float32)))
        g = g.to(self.device, torch.float32).reshape(slot_idx.numel(), -1)
        # accumulate=True: duplicates sum in a fixed order on the card
        self._gacc.index_put_((slot_idx,), g, accumulate=True)

    def end_pass(self, assign=False):
        """Sync the pass back to the host table and clear the cache:
        ``assign`` writes the rows' values, else the merged gradients of
        the rows that have one are pushed at the cache's ``lr``."""
        if self._keys is None:
            return
        n = self._n_real
        if assign:
            vals = self._rows[:n].cpu().numpy()
            self.client.assign(self.table_id, self._keys, vals)
            self.pushes += 1
        else:
            g = self._gacc[:n].cpu().numpy()
            nz = np.any(g != 0, axis=1)
            if nz.any():
                self.client.push(self.table_id, self._keys[nz], g[nz],
                                 lr=self.lr)
                self.pushes += 1
        self._keys = None
        self._rows = self._gacc = None
