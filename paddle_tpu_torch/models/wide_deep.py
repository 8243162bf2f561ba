"""Wide&Deep on the parameter server (reference:
``paddle_tpu/models/wide_deep.py``, lines 31-93: ``WideDeep``,
``wide_deep_loss``, ``zipf_ids``, ``ctr_batches``; and ``bench.py``'s
``widedeep`` mode, ``measure_widedeep``, lines 767-862).

``WideDeep`` holds only the dense arms: the sparse rows arrive gathered,
``[batch, slots * dim]``, from the pass cache or the lookup. The numpy
data generators are the reference's, so a seed gives the same batches.

``WideDeepBench`` is ``measure_widedeep`` in the port, step for step;
``run()`` drives it once:

- a ``TheOnePSRuntime`` with a ``LocalPs`` of one host table (table 0:
  dim 8, ``init_range`` 0.01, lr 0.1, Adagrad) and an
  ``AsyncCommunicator``, started;
- the deep MLP ``Sequential(Linear(8 * slots, 64), ReLU(), Linear(64,
  1))`` with ``Adam(1e-3)``, the ``DevicePassCache`` at lr 0.1 and a
  ``CompiledPassStep`` with the device Adagrad at lr 0.1, the loss
  ``binary_cross_entropy_with_logits(out[:, 0], labels)``;
- batches from ``RandomState(0)``: a teacher ``true_w = randn(vocab)``,
  ids ``randint(0, vocab, (n, slots))``, labels ``true_w[ids].sum(1) >
  0``;
- a warm pass of 2 batches, then ``steps`` batches (made before the
  timer) in passes of 10, each pass padded to ``vocab`` rows and ended
  with ``end_pass(assign=True)``; the host waits for the card once, at
  the end;
- the held-out AUC over 4096 new rows: ``distributed_lookup_table(lr=
  0.0)`` under ``no_grad``, the MLP, ``sigmoid`` and ``Auc``.

The sizes come from the caller: ``bench.py``'s accelerator sizes
(``ACCELERATOR_SIZES``: batch 512, 16 slots, 60 steps, vocab 10,000) or
its CPU ones (``CPU_SIZES``: 128, 8, 30, 2000). Like the reference's,
the driver carries no instrumentation: a caller that splits a pass
wraps the cache's ``begin_pass``/``end_pass`` and ``pass_step``.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import tensor as T
from ..distributed.ps import (CompiledPassStep, DevicePassCache, LocalPs,
                              TheOnePSRuntime, distributed_lookup_table)
from ..distributed.ps.communicator import AsyncCommunicator
from ..framework.device import resolve_device
from ..metric import Auc
from ..nn import functional as F
from ..nn.layer.activation import ReLU
from ..nn.layer.common import Linear
from ..nn.layer.container import Sequential
from ..optimizer import Adam

__all__ = ["WideDeep", "wide_deep_loss", "zipf_ids", "ctr_batches",
           "WideDeepSizes", "ACCELERATOR_SIZES", "CPU_SIZES", "deep_mlp",
           "WideDeepBench"]


class WideDeep(torch.nn.Module):
    """Dense arms over gathered rows: ``forward(flat_emb [batch, slots *
    dim]) -> logits [batch, 1]``, a wide linear plus a deep MLP over the
    same features. Parameters are drawn from ``rs`` in the reference's
    order (the wide arm, then the deep layers)."""

    def __init__(self, slots: int, dim: int,
                 hidden: Sequence[int] = (64, 32), *, device="cuda",
                 rs: Optional[np.random.RandomState] = None):
        super().__init__()
        self.slots = int(slots)
        self.dim = int(dim)
        in_f = self.slots * self.dim
        self.wide = Linear(in_f, 1, device=device, rs=rs)
        layers, prev = [], in_f
        for h in hidden:
            layers += [Linear(prev, int(h), device=device, rs=rs), ReLU()]
            prev = int(h)
        layers.append(Linear(prev, 1, device=device, rs=rs))
        self.deep = Sequential(*layers)

    def forward(self, flat_emb):
        return T.add(self.wide(flat_emb), self.deep(flat_emb))


def wide_deep_loss(logits, labels):
    """BCE-with-logits over ``[batch, 1]`` logits (the ``loss_fn`` of
    ``CompiledPassStep``)."""
    return F.binary_cross_entropy_with_logits(T.reshape(logits, [-1]),
                                              T.reshape(labels, [-1]))


def zipf_ids(rs: np.random.RandomState, vocab: int, size, alpha: float = 1.1):
    """Zipfian ids over ``[0, vocab)`` (rank r drawn with weight r^-alpha,
    id 0 the hottest), uint64; ``alpha <= 0`` is uniform."""
    if alpha <= 0:
        return rs.randint(0, vocab, size).astype(np.uint64)
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** alpha
    w /= w.sum()
    return rs.choice(vocab, size=size, p=w).astype(np.uint64)


def ctr_batches(steps: int, batch: int, slots: int, vocab: int,
                alpha: float = 1.1, seed: int = 0):
    """``steps`` batches of (ids ``[batch, slots]`` uint64, labels
    ``[batch]`` fp32): Zipfian ids, labels from a fixed random linear
    teacher."""
    rs = np.random.RandomState(seed)
    true_w = rs.randn(vocab)
    out = []
    for _ in range(int(steps)):
        ids = zipf_ids(rs, vocab, (batch, slots), alpha)
        labels = (true_w[ids.astype(np.int64)].sum(1) > 0).astype(np.float32)
        out.append((ids, labels))
    return out


class WideDeepSizes(NamedTuple):
    batch: int
    slots: int
    steps: int
    vocab: int


ACCELERATOR_SIZES = WideDeepSizes(512, 16, 60, 10000)
CPU_SIZES = WideDeepSizes(128, 8, 30, 2000)
DIM = 8                     # table 0's row width
STEPS_PER_PASS = 10
EVAL_ROWS = 4096


def deep_mlp(slots: int, *, device="cuda", seed: int = 0) -> Sequential:
    """``bench.py``'s deep arm, ``Sequential(Linear(8 * slots, 64), ReLU(),
    Linear(64, 1))``, its weights from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    return Sequential(Linear(DIM * slots, 64, device=device, rs=rs), ReLU(),
                      Linear(64, 1, device=device, rs=rs))


def _bce_out0(out, labels):
    return F.binary_cross_entropy_with_logits(
        T.getitem(out, (slice(None), 0)), labels)


class WideDeepBench:
    """``measure_widedeep``'s set-up, pass and evaluation (see the module
    docstring). ``weights`` (a ``state_dict`` for ``deep_mlp``, e.g. from
    ``models.convert.dense_state_dict_from_numpy``) replaces the MLP's
    seeded weights. A context manager: leaving it stops the communicator,
    as ``close()`` does."""

    def __init__(self, sizes: WideDeepSizes, device="cuda", *,
                 weights=None, seed: int = 0):
        self.sizes = WideDeepSizes(*sizes)
        self.device = resolve_device(device)
        batch, slots, steps, vocab = self.sizes
        self.runtime = TheOnePSRuntime()
        self.ps = LocalPs()
        self.ps.create_table(0, dim=DIM, init_range=0.01, lr=0.1,
                             optimizer="adagrad")
        self.runtime.client = self.ps
        self.runtime.communicator = AsyncCommunicator(self.ps)
        self.runtime.communicator.start()
        self.deep = deep_mlp(slots, device=self.device, seed=seed)
        if weights is not None:
            self.deep.load_state_dict(weights)
        self.optimizer = Adam(learning_rate=1e-3,
                              parameters=self.deep.parameters())
        self.rs = np.random.RandomState(0)
        self.true_w = self.rs.randn(vocab)
        self.cache = DevicePassCache(self.ps, 0, lr=0.1, device=self.device)
        self.pass_step = CompiledPassStep(self.cache, self.deep,
                                          self.optimizer, _bce_out0,
                                          table_optimizer="adagrad",
                                          table_lr=0.1)
        self.losses: List[torch.Tensor] = []

    def make_batch(self, n: int):
        ids = self.rs.randint(0, self.sizes.vocab, (n, self.sizes.slots))
        labels = (self.true_w[ids].sum(1) > 0).astype("float32")
        return ids, labels

    def run_pass(self, pass_batches) -> torch.Tensor:
        """One pass over ``pass_batches``; returns its last loss (no
        wait)."""
        self.cache.begin_pass(
            np.concatenate([b[0].reshape(-1) for b in pass_batches]),
            pad_to=self.sizes.vocab)
        for b in pass_batches:
            loss = self.pass_step(self.cache, b)
            self.losses.append(loss)
        self.cache.end_pass(assign=True)
        return loss

    def evaluate(self, n: int = EVAL_ROWS) -> float:
        """The held-out AUC over ``n`` new rows (pulled, created if new,
        with no gradient pushed)."""
        auc = Auc()
        ids, labels = self.make_batch(n)
        with torch.no_grad():
            rows = distributed_lookup_table(ids, table_id=0, lr=0.0,
                                            device=self.device)
            logit = T.getitem(self.deep(T.reshape(rows, [n, -1])),
                              (slice(None), 0))
            prob = F.sigmoid(logit).cpu().numpy()
        preds = np.stack([1.0 - prob, prob], axis=1)
        auc.update(preds, labels[:, None])
        return float(auc.accumulate())

    def run(self) -> dict:
        """``measure_widedeep``: a warm pass of 2 batches, then
        ``steps`` batches in passes of ``STEPS_PER_PASS``, timed, with one
        wait for the card at the end; then the held-out AUC. Returns
        examples/s, the seconds timed, the AUC, the last loss, every
        step's loss (the warm pass's too) and the table's rows."""
        batch, _, steps, _ = self.sizes
        self.run_pass([self.make_batch(batch) for _ in range(2)])   # warm
        batches = [self.make_batch(batch) for _ in range(steps)]
        t0 = time.perf_counter()
        for i in range(0, steps, STEPS_PER_PASS):
            loss = self.run_pass(batches[i:i + STEPS_PER_PASS])
        last = float(loss)                  # the one wait for the card
        seconds = time.perf_counter() - t0
        return {"examples_per_s": batch * steps / seconds,
                "seconds": seconds, "auc": self.evaluate(), "loss": last,
                "losses": torch.stack(self.losses).cpu().tolist(),
                "table_rows": self.ps.table_size(0)}

    def close(self) -> None:
        self.runtime.communicator.stop()

    def __enter__(self) -> "WideDeepBench":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
