"""Optimizers (reference: ``paddle_tpu/optimizer/__init__.py`` ``SGD``,
``Momentum``, ``Adam``, ``AdamW``; ``lr``, the learning-rate
schedulers).

The four rules that have a fused kernel (``ops/fused_update.py``
``FUSED_RULES``). The per-parameter ``_update`` runs the same arithmetic
as the fused update's plain version, ``update_math`` on the ``svec``
that ``scalar_prep`` builds, so the rules exist once: fp32 master math
in the reference's op order, weight decay added to the gradient (SGD,
Momentum, Adam) or decoupled after the step (AdamW), bias-corrected Adam
moments. The scalars (``lr``, beta powers) are 0-dim device tensors, so
every division is by a tensor, never by a Python number.
"""
from __future__ import annotations

import torch

from ..ops.fused_update import rule_spec, scalar_prep, slot_names, update_math
from . import lr
from .fused import FusedFlatUpdater
from .optimizer import Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW",
           "FusedFlatUpdater", "lr"]


class _FusedRule(Optimizer):
    """A rule with a fused form: ``_update`` is ``update_math`` on one
    parameter."""

    def _update(self, p, g, s, lr_, lm, wd):
        kind, hyper = rule_spec(self)
        svec, scalars = scalar_prep(kind, hyper, s, lr_, lm)
        names = slot_names(kind)
        new_p, arrs = update_math(p.to(torch.float32), g.to(torch.float32),
                                  [s[nm] for nm in names], svec, kind=kind,
                                  hyper=hyper, wd=wd)
        return new_p, {**dict(zip(names, arrs)), **scalars}


class SGD(_FusedRule):
    pass


class Momentum(_FusedRule):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}


class Adam(_FusedRule):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slots(self, p):
        z = dict(dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros(p.shape, **z),
                "moment2": torch.zeros(p.shape, **z),
                "beta1_pow": torch.ones((), **z),
                "beta2_pow": torch.ones((), **z)}


class AdamW(Adam):
    """Decoupled weight decay. ``apply_decay_param_fun(name)`` reads the
    parameter's ``name`` attribute (set it on the tensor; unnamed
    parameters pass ``""``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _param_wd(self, p):
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(getattr(p, "name", "")):
            return 0.0
        return super()._param_wd(p)
