"""Optimizer base (reference: ``paddle_tpu/optimizer/optimizer.py``
``Optimizer``: ``get_lr``, ``set_lr``, ``set_lr_scheduler``,
``_init_slots``, ``_wd_coeff``, ``_param_wd``, ``_clip_cfg``, ``step``
with ``_build_step_fn``'s clip, ``clear_grad``/``clear_gradients`` and
``minimize``, lines 187-240).

``parameters`` are eager ``Parameter``s (``Layer.parameters()``) or
plain ``torch.Tensor``s (a model's ``torch.nn.Module.parameters()``);
the optimizer works on their payloads and keeps each one's slots by it,
so ``step()`` updates every payload in place and a leaf stays the same
leaf. Per-parameter hyperparameters ride on the payloads, as in the
reference on its parameters: ``optimize_attr = {"learning_rate": mult}``
scales the learning rate, ``regularizer`` (anything with ``_coeff``)
overrides the weight decay, ``need_clip=False`` keeps a gradient out of
``grad_clip`` (``ParamAttr``; the reference's step clips every
gradient, ``ROADMAP.md`` Queue C).

**The update.** The reference's eager step is one compiled function
over all the parameters. On the card ``step()`` is one
``fused_update_buckets`` launch (``ops/fused_update.py``, ``PERF.md``
row 6) over a ``BucketTable`` with one entry a parameter: flat views of
the parameter and of its (clipped) gradient, its moments, its own
``wd`` and ``lr_mult``, its own beta powers (the table's, which the
kernel steps; ``_slots`` holds views of the current ones). The table is
kept while no pointer in it moves (``BucketTable.key``). A parameter
the kernel cannot take raises (a dtype other than fp32, bf16 and fp16,
which has no form of the kernel; a rule without a fused form, naming its
``ROADMAP.md`` item, "training options"); there is no other path on the
card for the four
fused rules (SGD, Momentum, Adam, AdamW). The reference has no kernel
for its other rules (Adagrad, Adadelta, Adamax, RMSProp, Lamb, Lars,
DGCMomentum, ``_per_parameter``): its eager step runs them as jnp, and
the port runs their PyTorch rule parameter by parameter on the card. On
the CPU ``step()`` applies each rule's plain version (``_update``, the
same arithmetic as the kernel's plain version) parameter by parameter.

**State.** ``state_dict()`` holds each slot as a numpy array under
``{param.name}.{slot}`` (``param_{i}`` for a parameter without a name)
and the scheduler's state under ``LR_Scheduler``, the reference's keys
(``paddle_tpu/optimizer/optimizer.py:295-308``). After a
``FusedFlatUpdater`` (``jit.TrainStep``) stepped last, it reads each
parameter's slots out of the updater's flat buckets, as the reference's
``_sync_from_compiled`` reads its compiled step's (``:274-293``).
``set_state_dict`` follows the reference's rules (``:308-391``): names
are trusted when one side's name set contains the other's, auto-named
parameters otherwise fall back to position, and a slot of the wrong shape
is refused without a word. A loaded moment is copied into the slot that
already holds it, so the card's ``BucketTable`` keeps its pointers; the
loaded beta powers are new tensors, which the table loads before its next
launch (``BucketTable.load_powers``). The last writer of the slots wins:
``step()`` and ``set_state_dict`` mark the optimizer's own, and a
``FusedFlatUpdater`` imports them before its next step.

``learning_rate`` is a float or an ``LRScheduler`` (``optimizer/lr.py``),
read by ``get_lr()`` at every step. ``grad_clip`` is one of
``nn.ClipGradByGlobalNorm``, ``ClipGradByNorm`` or ``ClipGradByValue``:
``step()`` clips copies of the gradients, cast to their parameters'
dtypes, before the update (``nn/clip.py`` ``clip_grads``), as the
reference's compiled step does; the copies go into buffers kept from
step to step, so that a clipped step's table stays the same; ``TrainStep`` clips its flat gradient
buckets the same way.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..framework.autograd import unwrap
from ..framework.grads import clear_grad
from ..framework.io import to_numpy, to_torch
from ..nn.clip import clip_grads
from ..ops.fused_update import (BUCKET_DTYPES, BucketTable,
                                fused_update_buckets, rule_spec, slot_names)
from .lr import LRScheduler

__all__ = ["Optimizer", "lr_mult", "param_name"]

TRAINING_OPTIONS = "ROADMAP Queue A 5, 'training options'"


def lr_mult(p) -> float:
    """The parameter's learning-rate multiplier (1.0 unless set)."""
    return float(getattr(unwrap(p), "optimize_attr", {}).get(
        "learning_rate", 1.0))


def param_name(p) -> str:
    """The parameter's Paddle name ("" unless it has one)."""
    return getattr(unwrap(p), "_paddle_name", "")


def _auto_named(p) -> bool:
    """True for a parameter whose name ``Layer.create_parameter`` made
    (no ``ParamAttr(name=)``)."""
    return getattr(unwrap(p), "_paddle_auto_named", False)


class Optimizer:
    # a rule without a fused kernel that runs parameter by parameter on
    # the card (the module docstring)
    _per_parameter = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        self._parameter_list: List = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._slots: Dict[int, Dict[str, torch.Tensor]] = {}
        self._accumulated_steps = 0
        self._table = None          # the card's BucketTable of the last step
        # gradients clipped, or cast to their parameters' dtypes
        self._grad_bufs: Dict[int, torch.Tensor] = {}
        self._lr = None             # (value, device, 0-dim tensor)
        # who wrote the slots last: "eager" (step, set_state_dict) or a
        # weak reference to a FusedFlatUpdater
        self._slot_writer = None

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
        reg = getattr(unwrap(p), "regularizer", None)
        if reg is not None:
            return float(getattr(reg, "_coeff", self._wd_coeff()))
        return self._wd_coeff()

    def _lr_tensor(self, device: torch.device) -> torch.Tensor:
        """The learning rate as a 0-dim fp32 tensor, filled on ``device``
        (the host does not wait for a copy)."""
        return torch.full((), self.get_lr(), dtype=torch.float32,
                          device=device)

    # ------------------------------------------------------------ step
    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a gradient."""
        params = [t for t in map(unwrap, self._parameter_list)
                  if t.grad is not None and t.requires_grad]
        if not params:
            return
        clip = self._clip_cfg()
        # each gradient in its parameter's dtype, as the reference's step
        # casts it (GradScaler.unscale_ leaves fp32 gradients on 16-bit
        # parameters); cast and clipped ones are copies, never the
        # caller's .grad
        grads = [self._grad_copy(t) if clip is not None
                 or t.grad.dtype != t.dtype else t.grad for t in params]
        if clip is not None:
            clipped = [g for g, t in zip(grads, params)
                       if getattr(t, "need_clip", True)]
            if clipped:
                clip_grads(clipped, clip)
        on_card = [t.device.type == "cuda" for t in params]
        if any(on_card):
            if not all(on_card):
                raise ValueError("step(): the parameters are on the card "
                                 "and on the CPU; one optimizer updates "
                                 "one device's")
            self._step_on_card(params, grads)
        else:
            self._step_plain(params, grads)
        self._accumulated_steps += 1
        self._slot_writer = "eager"

    def _grad_copy(self, t) -> torch.Tensor:
        """``t.grad`` copied, in ``t``'s dtype (rounded to nearest even,
        as ``.to``), into the buffer kept for ``t``, made at the first
        step: the card's table keeps its pointer from step to step."""
        g = t.grad
        buf = self._grad_bufs.get(id(t))
        if buf is None or buf.shape != g.shape or buf.dtype != t.dtype \
                or buf.device != g.device:
            buf = self._grad_bufs[id(t)] = torch.empty_like(g, dtype=t.dtype)
        return buf.copy_(g)

    def _lr_tensor_kept(self, device) -> torch.Tensor:
        """This step's learning rate on ``device``: the kept tensor while
        the value stays, else a new one (never written after it is made,
        so a launch still queued reads its own step's rate)."""
        lr = self.get_lr()
        if self._lr is None or self._lr[:2] != (lr, device):
            self._lr = (lr, device, self._lr_tensor(device))
        return self._lr[2]

    def _slots_of(self, t) -> Dict[str, torch.Tensor]:
        slots = self._slots.get(id(t))
        if slots is None:
            slots = self._slots[id(t)] = self._init_slots(t)
        return slots

    def _step_plain(self, params, grads):
        """Each rule's plain version, parameter by parameter."""
        lrs = {}
        for t, g in zip(params, grads):
            lr = lrs.get(t.device)
            if lr is None:
                lr = lrs[t.device] = self._lr_tensor(t.device)
            new_p, new_s = self._update(t, g, self._slots_of(t), lr,
                                        lr_mult(t), self._param_wd(t))
            t.copy_(new_p)
            self._slots[id(t)] = new_s

    def _step_on_card(self, params, grads):
        """One ``fused_update_buckets`` launch over a table of every
        parameter (module docstring)."""
        spec = rule_spec(self)
        if spec is None and self._per_parameter:
            self._step_plain(params, grads)
            return
        if spec is None:
            raise NotImplementedError(
                f"{type(self).__name__}.step() on the card: the rule has "
                f"no fused kernel in the port ({TRAINING_OPTIONS})")
        kind, hyper = spec
        names = slot_names(kind)
        entries = []
        for t, g in zip(params, grads):
            if t.dtype not in BUCKET_DTYPES:
                raise NotImplementedError(
                    f"step() on the card takes fp32, bf16 and fp16 "
                    f"parameters; {t.dtype} has no form of the update "
                    f"kernel")
            s = self._slots_of(t)
            entries.append((t.view(-1), g.reshape(-1),
                            [s[nm].view(-1) for nm in names],
                            self._param_wd(t), lr_mult(t)))
        table = self._table
        if table is None or table.kind != kind or table.hyper != hyper \
                or table.key != BucketTable.pointers(entries):
            table = self._table = BucketTable(kind, hyper, entries)
        if table.adam:
            slots = [self._slots[id(t)] for t in params]
            if any(s["beta1_pow"] is not a or s["beta2_pow"] is not c
                   for s, (a, c) in zip(slots, table.powers())):
                table.load_powers([(s["beta1_pow"], s["beta2_pow"])
                                   for s in slots])
        fused_update_buckets(table, self._lr_tensor_kept(table.device))
        if table.adam:
            for t, (b1p, b2p) in zip(params, table.powers()):
                self._slots[id(t)].update(beta1_pow=b1p, beta2_pow=b2p)

    # ----------------------------------------------------------- state
    def _sync_from_updater(self):
        """When a ``FusedFlatUpdater`` wrote the slots last, each
        parameter's slots as copies of its views of the flat buckets (a
        0-dim slot is the bucket's)."""
        w = self._slot_writer
        upd = None if w is None or w == "eager" else w()
        if upd is None:
            return
        for b in upd.buckets:
            flat = upd._slots.get(b.index)
            if flat is None:
                continue
            for pi, off, n, shape in zip(b.param_indices, b.offsets,
                                         b.numels, b.shapes):
                self._slots[id(upd.params[pi])] = {
                    k: v.detach().clone() if v.dim() == 0
                    else v[off:off + n].view(shape).clone()
                    for k, v in flat.items()}

    def state_dict(self):
        self._sync_from_updater()
        sd = {}
        for i, p in enumerate(self._parameter_list):
            slots = self._slots.get(id(unwrap(p)))
            if slots:
                key = param_name(p) or f"param_{i}"
                for k, v in slots.items():
                    sd[f"{key}.{k}"] = to_numpy(v)
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def _load_slots(self, state_dict, key, t) -> bool:
        """``t``'s slots from the entries ``{key}.{slot}``: False (and
        nothing written) when none is there or one has another shape."""
        fresh = self._init_slots(t)
        found = {}
        for k, f in fresh.items():
            v = state_dict.get(f"{key}.{k}")
            if v is None:
                continue
            v = unwrap(v)
            v = v if isinstance(v, torch.Tensor) else to_torch(v)
            if tuple(v.shape) != tuple(f.shape):
                return False            # another parameter's state
            found[k] = v
        if not found:
            return False
        cur = self._slots.get(id(t))
        if cur is None or set(cur) != set(fresh):
            cur = self._slots[id(t)] = fresh
        for k, f in fresh.items():
            v = found.get(k, f)
            if cur[k] is not f and cur[k].dim():
                cur[k].copy_(v)         # in place: the table's pointers
            else:
                cur[k] = v.to(f.device, f.dtype).clone()
        return True

    def set_state_dict(self, state_dict):
        """Load ``state_dict()``'s entries (the module docstring)."""
        self._slot_writer = "eager"
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        # the saved prefixes in save order: the positional fallback when
        # auto-generated names differ between two builds of one model
        prefixes = []
        for k in state_dict:
            if k == "LR_Scheduler" or "." not in k:
                continue
            pre = k.rsplit(".", 1)[0]
            if pre not in prefixes:
                prefixes.append(pre)
        keys = [param_name(p) or f"param_{i}"
                for i, p in enumerate(self._parameter_list)]
        trainable = [unwrap(p).requires_grad for p in self._parameter_list]
        auto = [_auto_named(p) for p in self._parameter_list]
        all_auto = {k for k, a in zip(keys, auto) if a}
        trainable_auto = {k for k, a, tr in zip(keys, auto, trainable)
                          if a and tr}
        user_names = {k for k, a, p in zip(keys, auto, self._parameter_list)
                      if param_name(p) and not a}
        auto_prefixes = set(prefixes) - user_names
        # auto names are trusted only when one side's set contains the
        # other's; on a partial overlap they fall back to position
        auto_consistent = (auto_prefixes <= all_auto
                           or trainable_auto <= auto_prefixes)
        missed = []
        for p, key, a, tr in zip(self._parameter_list, keys, auto,
                                 trainable):
            t = unwrap(p)
            if (auto_consistent or not a) and self._load_slots(
                    state_dict, key, t):
                if key in prefixes:
                    prefixes.remove(key)
            elif tr:
                missed.append(t)
        j = 0
        for t in missed:
            while j < len(prefixes):
                j += 1
                if self._load_slots(state_dict, prefixes[j - 1], t):
                    break

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            clear_grad(unwrap(p))

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``."""
        loss.backward()
        self.step()
        return [], []
