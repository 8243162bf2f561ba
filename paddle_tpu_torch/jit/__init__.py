"""The training step (reference: ``paddle_tpu/jit/__init__.py``
``TrainStep``: the ``accum == 1`` and micro-batch branches of
``pure_step``, the data-parallel gradient wire ``grad_comm``, the
optimizer's ``grad_clip`` (``_apply_clip``) and its learning rate read
at every call: lines 368-400, 430-510, 598-828, 896-898, 975-1050 and
1083-1100).

    step = TrainStep(model, loss_fn, optimizer)
    loss = step(inputs=(ids,), labels=(labels,))   # params updated in place
    # loss_fn is called as loss_fn(*model_outputs, *labels)

One call runs the forward and the loss, autograd's backward, and the
optimizer update. The reference compiles all of it into one XLA program
with a per-parameter update; the port runs eagerly and sends the update
through the fused kernel, one launch per step over every flat bucket
(``optimizer.FusedFlatUpdater``), instead of ~12 launches per
parameter. Lamb, Lars and DGCMomentum, whose norms and top-k need a
parameter whole, take ``optimizer.PerParameterUpdater`` instead: their
``_update`` parameter by parameter, as the reference's step runs every
rule (``opt._update``, ``paddle_tpu/jit/__init__.py:903``). DGCMomentum
reads its step count at every step and ramps its sparsity, where the
reference's step reads it once, when it is traced (ROADMAP Queue C).
The parameters are grouped by
(lr_mult, weight decay) before bucketing, so every bucket is uniform and
per-parameter hyperparameters work as in the reference; with one group
the bucket plan is the reference's. The result equals the reference's
per-parameter update element for element up to FMA contraction (the
reference's own <= 8 ulp contract). Gradients accumulate in place in the
updater's flat gradient buffers.

``grad_accum_steps > 1`` splits the leading batch dimension into that
many micro-batches, sums their gradients in order and divides by the
count, and returns the mean of the micro-batch losses, as the
reference's scan does. The sum is fp32 whatever the parameters' dtype
(the reference's ``result_type(param, float32)``): an fp32 bucket sums
in place in its gradient buffer; a bf16 bucket's micro-batch gradients
are added into an fp32 sum, which is divided and only then written back
to the bf16 buffer, rounded to nearest even, the reference's
``g.astype(param dtype)`` before the update's fp32 math.

``grad_comm`` (a ``GradCommConfig`` or a codec name) makes the step data
parallel over the ranks of ``torch.distributed`` (``distributed.spawn``
and ``init_parallel_env`` start them; each holds a full replica). Where
the reference runs ``shard_map`` over the mesh's data axis, the port
runs one process per rank:

- rank ``r`` of ``W`` runs forward and backward on rows
  ``[r*B/W, (r+1)*B/W)`` of the global batch ``B``;
- the loss and floating buffers are AVG-reduced;
- each bucket of the communicator's plan is reduced. With a blockwise
  codec and uniform per-bucket ``(lr_mult, wd)`` (the fused path) the
  summed payload goes straight into ``FusedFlatUpdater.step_dequant``:
  one ``fused_dequant_update_buckets`` kernel a step decodes and updates
  every bucket, and the decoded gradient never reaches memory. Otherwise
  ``reduce_bucket`` writes the averaged gradients into ``.grad`` and the
  update is ``step()``. A bf16 model's buckets (bf16 blocks and tables,
  the fp32 final norm) take the same path: a bf16 bucket is encoded from
  bf16 where it lies (from fp32 when an error-feedback residual is added
  first, as in the reference), and its decoded gradient is rounded to
  bf16 before the update, the reference's cast chain;
- the error-feedback residuals are per rank, carried in
  ``grad_comm_communicator._residuals``. Every rank applies the same
  update to the same summed payload, so the replicas stay identical.

With one rank the knob is inert: the step is the plain one, and
``comm_stats`` stays None. ``grad_comm`` needs ``grad_accum_steps == 1``,
as in the reference.

The optimizer's ``grad_clip`` (``nn/clip.py``) clips the step's mean
gradient before the update, on every path: the flat gradient buckets of
a plain step; the fp32 micro-batch means of an accumulated step, before
a bf16 bucket's mean is rounded to bf16 (the reference clips its fp32
sums, then casts); the decoded gradients of a data-parallel step, whose
fused dequantizing update is then off (as in the reference: the clip
needs the decoded gradient), so the step decodes, clips and runs
``step()``. "By norm" clips each parameter's segment of its bucket. The
global norm sums the buckets' fp32 sums of squares, where the reference
sums the parameters' in its own order: the norm differs by fp32
rounding, not more. The learning rate is the optimizer's ``get_lr()``
at each call (a float or an ``LRScheduler``, which the caller steps).

A model's floating buffers that its forward moves (a batch norm's
running statistics, ``nn/functional/norm.py``) move in place once a
forward, as the reference's step carries them: once a step, once a
micro-batch with ``grad_accum_steps`` (its scan carries them from one
micro-batch to the next), and averaged over the ranks on the data-
parallel path. Their gradient never reaches the bucket plan: buffers are
not parameters. Gradients are the eager ones, the reference's op by op;
its compiled step differs from its own eager step where a
``detach()`` is transparent to ``jax.grad`` (ROADMAP Queue C: the
batch statistics).

``inputs`` and ``labels`` may hold ``None`` (``bench.py``'s fused-loss
step passes ``inputs=(ids, None, labels)``, its bert step ``inputs=(ids,
None, None, None, mlm)``); it reaches the model as ``None``.

Called inside ``amp.auto_cast``, the step runs the forward and the loss
under the caller's policy (the cast points of ``paddle_tpu_torch/amp``,
as the reference's trace casts them). The parameters stay what they
are, fp32 masters for ``bench.py``'s bert step: every cast is a
``Tensor.to``, so their gradients come back in fp32 and the update is
the fp32 one-launch kernel over the usual bucket plan. The returned loss
is fp32 (under O2 the reference's final "add" makes it a bf16 value).

Not in this slice (``NotImplementedError``): ``batch_spec`` and
``grad_fn`` (ROADMAP Queue A 5, "parallelism").
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..distributed import collective as _coll
from ..distributed.collective import ReduceOp
from ..distributed.env import get_rank, get_world_size, is_initialized
from ..distributed.grad_comm import (BLOCK_CODECS, GradBucket,
                                     GradCommConfig, GradCommunicator,
                                     build_buckets)
from ..framework.device import to_device
from ..framework.modules import torch_buffers, torch_parameters
from ..nn.clip import clip_grads
from ..ops.fused_update import rule_spec
from ..optimizer.fused import (UNFUSABLE_OPTIMIZERS, FusedFlatUpdater,
                               PerParameterUpdater)
from ..optimizer.optimizer import lr_mult

__all__ = ["TrainStep", "uniform_buckets"]


def _hypers(p, optimizer) -> Tuple[float, float]:
    """The parameter's (lr_mult, weight decay)."""
    return lr_mult(p), float(optimizer._param_wd(p))


def uniform_buckets(params, optimizer) -> List[GradBucket]:
    """The reference's bucket plan per (lr_mult, wd) group of ``params``,
    indices into ``params``, numbered in order."""
    groups: Dict[Tuple[float, float], List[int]] = {}
    for i, p in enumerate(params):
        groups.setdefault(_hypers(p, optimizer), []).append(i)
    out: List[GradBucket] = []
    for idx in groups.values():
        for b in build_buckets([params[i] for i in idx]):
            b.index = len(out)
            b.param_indices = [idx[j] for j in b.param_indices]
            out.append(b)
    return out


def _uniform(bucket, params, optimizer) -> bool:
    """True when the bucket's parameters share one (lr_mult, wd)."""
    return len({_hypers(params[pi], optimizer)
                for pi in bucket.param_indices}) == 1


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class TrainStep:
    """One training step: forward + loss + backward + fused update."""

    def __init__(self, model, loss_fn, optimizer, grad_accum_steps=1,
                 batch_spec=None, grad_fn=None, grad_comm=None):
        for name, val in (("batch_spec", batch_spec), ("grad_fn", grad_fn)):
            if val is not None:
                raise NotImplementedError(
                    f"TrainStep({name}=...) is not ported yet (ROADMAP "
                    f"Queue A 5, 'parallelism')")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum = int(grad_accum_steps)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        params = [p for p in torch_parameters(model) if p.requires_grad]
        self._gc_comm = None
        self.comm_stats = None
        buckets = uniform_buckets(params, optimizer)
        self._gc_fused = False
        if grad_comm is not None:
            if isinstance(grad_comm, str):
                grad_comm = GradCommConfig(codec=grad_comm)
            elif not isinstance(grad_comm, GradCommConfig):
                raise TypeError(f"grad_comm must be a GradCommConfig or a "
                                f"codec name, got {type(grad_comm).__name__}")
            if self.grad_accum > 1:
                raise ValueError(
                    "TrainStep(grad_comm=...) expresses the gradient "
                    "all-reduce explicitly in-trace; it supports the "
                    "plain fused step (grad_accum_steps == 1) or an "
                    "external grad_fn that marks handles_grad_comm (the "
                    "1F1B pipeline engine) — not this combination")
            self._gc_comm = GradCommunicator(grad_comm)
            plan = self._gc_comm.buckets_for(params)
            if all(_uniform(b, params, optimizer) for b in plan):
                # the updater's flat buffers follow the wire's buckets, so
                # a bucket's summed payload lines up with its parameters;
                # a clip needs the decoded gradients, so it turns the
                # fused dequantizing update off
                buckets = plan
                self._gc_fused = (grad_comm.codec in BLOCK_CODECS
                                  and optimizer._clip_cfg() is None
                                  and rule_spec(optimizer) is not None)
        if type(optimizer).__name__ in UNFUSABLE_OPTIMIZERS:
            self.updater = PerParameterUpdater(optimizer, params)
        else:
            self.updater = FusedFlatUpdater(optimizer, params,
                                            buckets=buckets,
                                            caller_clips=True)
        self.device = params[0].device
        self._accum_div = None

    @property
    def buckets(self) -> List[GradBucket]:
        return self.updater.buckets

    @property
    def grad_comm_communicator(self):
        """The ``GradCommunicator`` carrying this step's error-feedback
        residuals (None without ``grad_comm``); its ``state_dict()`` /
        ``load_state_dict()`` are the resume surface."""
        return self._gc_comm

    def _gc_world(self) -> int:
        """Ranks the gradient is averaged over: the process group's size
        with ``grad_comm``, else 1 (the knob is inert)."""
        if self._gc_comm is None or not is_initialized():
            return 1
        return get_world_size()

    def _tensor(self, x):
        if x is None:
            return None
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
        world = self._gc_world()
        if world > 1:
            return self._dp_step(inputs, labels, world)
        if self.grad_accum == 1:
            loss = self._loss(inputs, labels)
            loss.backward()
            loss = loss.detach()
            self._clip(self.updater.flat_grads())
        else:
            loss = self._accumulate(inputs, labels)
        self.updater.step()
        return loss

    def _clip(self, flats) -> None:
        """Clip the buckets' flat gradients ``flats`` (or fp32 tensors laid
        out as them) in place by the optimizer's ``grad_clip``."""
        cfg = self.optimizer._clip_cfg()
        if cfg is not None:
            clip_grads(flats, cfg, groups=[list(zip(b.offsets, b.numels))
                                           for b in self.buckets])

    def _accumulate(self, inputs, labels) -> torch.Tensor:
        """Forward and backward over the micro-batches; leaves the mean
        gradient in the updater's buffers (fp32 sums, see the module
        docstring) and returns the mean loss."""
        accum = self.grad_accum

        def micro(x, i):
            if x is None or x.dim() == 0:
                return x
            if x.shape[0] % accum:
                raise ValueError(f"batch {x.shape[0]} does not split "
                                 f"into {accum} micro-batches")
            return x.chunk(accum)[i]

        losses = []
        sums = [None] * len(self.buckets)   # fp32 sums of bf16 buckets
        for i in range(accum):
            li = self._loss(tuple(micro(x, i) for x in inputs),
                            tuple(micro(x, i) for x in labels))
            li.backward()
            losses.append(li.detach())
            with torch.no_grad():
                for j, g in enumerate(self.updater.flat_grads()):
                    if g.dtype == torch.float32:
                        continue
                    if sums[j] is None:
                        sums[j] = g.to(torch.float32)
                    else:
                        sums[j].add_(g)
                    g.zero_()
        if self._accum_div is None:
            self._accum_div = torch.full((), float(accum),
                                         dtype=torch.float32,
                                         device=self.device)
        with torch.no_grad():
            flats = self.updater.flat_grads()
            means = [g.div_(self._accum_div) if total is None
                     else total.div_(self._accum_div)
                     for g, total in zip(flats, sums)]
            self._clip(means)
            for g, total in zip(flats, sums):
                if total is not None:
                    g.copy_(total)
        return torch.stack(losses).mean()

    # ------------------------------------------------ data parallel step
    def _dp_step(self, inputs, labels, world: int) -> torch.Tensor:
        """One data-parallel step on this rank's shard of the batch."""
        rank = get_rank()

        def shard(x):
            if x is None or x.dim() == 0:
                return x
            if x.shape[0] % world:
                raise ValueError(f"batch {x.shape[0]} does not split over "
                                 f"{world} ranks")
            return x.chunk(world)[rank]

        loss = self._loss(tuple(shard(x) for x in inputs),
                          tuple(shard(x) for x in labels))
        loss.backward()
        comm = self._gc_comm
        with torch.no_grad():
            loss = loss.detach().clone()
            # the shard's mean loss -> the global mean (equal shards)
            _coll.all_reduce(loss, op=ReduceOp.AVG, group=comm.group)
            for buf in torch_buffers(self.model):
                if buf.is_floating_point():
                    _coll.all_reduce(buf, op=ReduceOp.AVG, group=comm.group)
        # on the fused path the communicator's plan is the updater's, so
        # the updater's flat gradient buffers are the buckets
        payloads = comm.sync(
            self.updater.params, world, path="traced",
            flats=self.updater.flat_grads() if self._gc_fused else None,
            payload_only=self._gc_fused)
        if self._gc_fused:
            self.updater.step_dequant(payloads, world,
                                      comm.config.block_size)
        else:
            self._clip(self.updater.flat_grads())
            self.updater.step()
        self.comm_stats = dict(comm.stats)
        return loss
