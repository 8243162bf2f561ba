"""Optimizer base (reference: ``paddle_tpu/optimizer/optimizer.py``
``Optimizer``: ``get_lr``, ``set_lr``, ``set_lr_scheduler``,
``_init_slots``, ``_wd_coeff``, ``_param_wd``, ``_clip_cfg``, the
per-parameter ``step`` with ``_build_step_fn``'s clip, and
``clear_grad``).

Each optimizer defines a per-parameter update rule ``_update(p, g,
slots, lr, lr_mult, wd) -> (new_p, new_slots)`` in plain PyTorch with the
reference's op order; ``step()`` applies it parameter by parameter. The
training step does not take this path: it runs the same rule over flat
buckets through the fused kernel (``optimizer/fused.py``).

Per-parameter hyperparameters ride on the parameter tensors, as in the
reference: ``p.optimize_attr = {"learning_rate": mult}`` scales the
learning rate, ``p.regularizer`` (anything with ``_coeff``) overrides
the weight decay.

``learning_rate`` is a float or an ``LRScheduler`` (``optimizer/lr.py``),
read by ``get_lr()`` at every update. ``grad_clip`` is one of
``nn.ClipGradByGlobalNorm``, ``ClipGradByNorm`` or ``ClipGradByValue``:
``step()`` clips the gradients, cast to their parameters' dtypes, before
the update (``nn/clip.py`` ``clip_grads``), as the reference's compiled
step does; ``TrainStep`` clips its flat gradient buckets the same way.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..nn.clip import clip_grads
from .lr import LRScheduler

__all__ = ["Optimizer", "lr_mult"]


def lr_mult(p) -> float:
    """The parameter's learning-rate multiplier (1.0 unless set)."""
    return float(getattr(p, "optimize_attr", {}).get("learning_rate", 1.0))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        self._parameter_list: List[torch.Tensor] = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._slots: Dict[int, Dict[str, torch.Tensor]] = {}
        self._accumulated_steps = 0

    # ------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when learning_rate is a "
                               "scheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _clip_cfg(self):
        """``grad_clip`` as ``(kind, value)``: ("global_norm", c),
        ("norm", c), ("value", (min, max)); None without a clip (or with
        a class the reference does not know, which it ignores too)."""
        gc = self._grad_clip
        if gc is None:
            return None
        cls = type(gc).__name__
        if cls == "ClipGradByGlobalNorm":
            return ("global_norm", gc.clip_norm)
        if cls == "ClipGradByNorm":
            return ("norm", gc.clip_norm)
        if cls == "ClipGradByValue":
            return ("value", (gc.min, gc.max))
        return None

    # ------------------------------------------------------ update rule
    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, p, g, slots, lr, lr_mult, wd):
        """Pure update: returns (new_p, new_slots). Override per rule."""
        raise NotImplementedError

    def _wd_coeff(self) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        return float(getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))

    def _param_wd(self, p) -> float:
        """Decay coefficient for one parameter: a per-parameter regularizer
        overrides the optimizer's."""
        if getattr(p, "regularizer", None) is not None:
            return float(getattr(p.regularizer, "_coeff", self._wd_coeff()))
        return self._wd_coeff()

    def _lr_tensor(self, device: torch.device) -> torch.Tensor:
        """The learning rate as a 0-dim fp32 tensor, filled on ``device``
        (the host does not wait for a copy)."""
        return torch.full((), self.get_lr(), dtype=torch.float32,
                          device=device)

    # ------------------------------------------------------------ step
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        params = [p for p in self._parameter_list
                  if p.grad is not None and p.requires_grad]
        if not params:
            return
        grads = [p.grad.to(p.dtype) for p in params]
        clip = self._clip_cfg()
        if clip is not None:
            # clip copies, never the caller's .grad
            grads = [g.clone() if g is p.grad else g
                     for g, p in zip(grads, params)]
            clip_grads(grads, clip)
        lrs = {}
        for p, g in zip(params, grads):
            lr = lrs.get(p.device)
            if lr is None:
                lr = lrs[p.device] = self._lr_tensor(p.device)
            slots = self._slots.get(id(p))
            if slots is None:
                slots = self._init_slots(p)
            new_p, new_s = self._update(p, g, slots, lr,
                                        lr_mult(p), self._param_wd(p))
            p.copy_(new_p)
            self._slots[id(p)] = new_s
        self._accumulated_steps += 1

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None
