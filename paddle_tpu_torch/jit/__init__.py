"""The training step (reference: ``paddle_tpu/jit/__init__.py``
``TrainStep``: the ``accum == 1`` and micro-batch branches of
``pure_step``).

    step = TrainStep(model, loss_fn, optimizer)
    loss = step(inputs=(ids,), labels=(labels,))   # params updated in place
    # loss_fn is called as loss_fn(*model_outputs, *labels)

One call runs the forward and the loss, autograd's backward, and the
optimizer update. The reference compiles all of it into one XLA program
with a per-parameter update; the port runs eagerly and sends the update
through the fused kernel, one launch per flat bucket
(``optimizer.FusedFlatUpdater``), so a step issues a few dozen update
launches instead of ~12 per parameter. The parameters are grouped by
(lr_mult, weight decay) before bucketing, so every bucket is uniform and
per-parameter hyperparameters work as in the reference; with one group
the bucket plan is the reference's. The result equals the reference's
per-parameter update element for element up to FMA contraction (the
reference's own <= 8 ulp contract). Gradients accumulate in place in the
updater's flat gradient buffers.

``grad_accum_steps > 1`` splits the leading batch dimension into that
many micro-batches, sums their gradients in order and divides by the
count, and returns the mean of the micro-batch losses, as the
reference's scan does.

Not in this slice (``NotImplementedError``): ``batch_spec``, ``grad_fn``
and ``grad_comm`` (ROADMAP Queue A, "gradient wire" and "parallelism").
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..distributed.grad_comm import GradBucket, build_buckets
from ..framework.device import to_device
from ..optimizer.fused import FusedFlatUpdater
from ..optimizer.optimizer import lr_mult

__all__ = ["TrainStep", "uniform_buckets"]


def uniform_buckets(params, optimizer) -> List[GradBucket]:
    """The reference's bucket plan per (lr_mult, wd) group of ``params``,
    indices into ``params``, numbered in order."""
    groups: Dict[Tuple[float, float], List[int]] = {}
    for i, p in enumerate(params):
        key = (lr_mult(p), float(optimizer._param_wd(p)))
        groups.setdefault(key, []).append(i)
    out: List[GradBucket] = []
    for idx in groups.values():
        for b in build_buckets([params[i] for i in idx]):
            b.index = len(out)
            b.param_indices = [idx[j] for j in b.param_indices]
            out.append(b)
    return out


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class TrainStep:
    """One training step: forward + loss + backward + fused update."""

    def __init__(self, model, loss_fn, optimizer, grad_accum_steps=1,
                 batch_spec=None, grad_fn=None, grad_comm=None):
        for name, val, item in (
                ("batch_spec", batch_spec, "parallelism"),
                ("grad_fn", grad_fn, "parallelism"),
                ("grad_comm", grad_comm, "gradient wire")):
            if val is not None:
                raise NotImplementedError(
                    f"TrainStep({name}=...) is not ported yet (ROADMAP "
                    f"Queue A, '{item}')")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum = int(grad_accum_steps)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        params = [p for p in model.parameters() if p.requires_grad]
        self.updater = FusedFlatUpdater(
            optimizer, params, buckets=uniform_buckets(params, optimizer))
        self.device = params[0].device
        self._accum_div = None

    @property
    def buckets(self) -> List[GradBucket]:
        return self.updater.buckets

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        arr = np.asarray(x)
        dtype = (torch.long if np.issubdtype(arr.dtype, np.integer)
                 else torch.float32)
        return to_device(arr, self.device, dtype)

    def _loss(self, inputs, labels) -> torch.Tensor:
        outs = _as_tuple(self.model(*inputs))
        return self.loss_fn(*outs, *labels).to(torch.float32)

    def __call__(self, inputs, labels=()) -> torch.Tensor:
        inputs = tuple(self._tensor(x) for x in _as_tuple(inputs))
        labels = tuple(self._tensor(x) for x in _as_tuple(labels))
        self.model.train()
        self.updater.zero_grad()
        accum = self.grad_accum
        if accum == 1:
            loss = self._loss(inputs, labels)
            loss.backward()
            loss = loss.detach()
        else:
            def micro(x, i):
                if x.dim() == 0:
                    return x
                if x.shape[0] % accum:
                    raise ValueError(f"batch {x.shape[0]} does not split "
                                     f"into {accum} micro-batches")
                return x.chunk(accum)[i]

            losses = []
            for i in range(accum):
                li = self._loss(tuple(micro(x, i) for x in inputs),
                                tuple(micro(x, i) for x in labels))
                li.backward()
                losses.append(li.detach())
            if self._accum_div is None:
                self._accum_div = torch.full((), float(accum),
                                             dtype=torch.float32,
                                             device=self.device)
            with torch.no_grad():
                for g in self.updater.flat_grads():
                    g.div_(self._accum_div)
            loss = torch.stack(losses).mean()
        self.updater.step()
        return loss
