"""Automatic mixed precision (reference: ``paddle_tpu/amp/__init__.py``:
``WHITE_LIST``/``BLACK_LIST``, ``amp_state``, ``auto_cast``/``amp_guard``,
``amp_cast_inputs``, ``decorate`` and ``GradScaler``).

    with auto_cast(level="O2", dtype="bfloat16"):
        loss = step(inputs=(ids, None, None, None, mlm), labels=(nsp,))

The policy is the reference's, not ``torch.autocast``'s (whose op lists
and cast rules differ). Where the reference's dispatch layer
(``framework/autograd.py`` ``call_op``) casts an op's tensor inputs, the
port's op calls ``cast(op_name, *tensors)`` with the reference's op name
(the functionals of ``nn/functional``, the tensor ops of
``paddle_tpu_torch/tensor``, BERT's loss ops). With no amp active that
returns its inputs untouched and launches nothing. Otherwise it calls
``amp_cast_inputs`` through this module's global at call time, so a
test can wrap it here as it wraps the reference's:

- O1: an op on the white list casts its floating inputs to the amp
  dtype, one on the black list casts bf16/fp16 inputs to fp32, any other
  op takes its inputs as they come (fp32 + bf16 promotes to fp32);
- O2: every op casts its floating inputs to the amp dtype, except the
  black list's, which cast to fp32.

A cast is ``Tensor.to``, so autograd carries the gradient back to the
fp32 parameter in fp32. The state is thread-local, as in the reference.

``decorate(level="O2")`` casts a model's fp32 parameters to the amp
dtype in place; the optimizers keep fp32 moments (the port's update
rules compute in fp32). ``GradScaler`` is the reference's dynamic loss
scaling: inert for bf16 in practice (the scale never overflows), the
full protocol when asked for, as fp16 needs it (check finite, skip and
shrink, or grow after ``incr_every_n_steps`` good steps). Its finite
check is one flag on the device over every gradient, read once a step
(``GradScaler.host_reads`` counts the reads).
"""
from __future__ import annotations

import contextlib
import threading
from typing import List

import torch

from ..framework.flags import flag
from ..framework.grads import hold_grad, restore_grad_dtype
from ..framework.modules import torch_parameters

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_state", "auto_cast", "amp_guard",
           "amp_cast_inputs", "cast", "decorate", "GradScaler"]

_tls = threading.local()

# the reference's O1 white/black lists (imperative/amp_auto_cast.cc)
WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm",
              "einsum", "addmm", "mv"}
BLACK_LIST = {"exp", "log", "log2", "log10", "mean", "sum", "softmax",
              "log_softmax", "cross_entropy", "layer_norm", "batch_norm",
              "norm", "cumsum", "logsumexp", "softmax_with_cross_entropy"}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_LOW = (torch.bfloat16, torch.float16)


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"amp dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}") from None


def amp_state():
    """The active policy (a dict: level, dtype, white, black) or None."""
    return getattr(_tls, "amp", None)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """``paddle.amp.auto_cast``: the policy for ops run inside the block
    on this thread; ``enable=False`` turns an outer one off."""
    prev = amp_state()
    if enable:
        white, black = set(WHITE_LIST), set(BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        _tls.amp = {"level": level, "dtype": _dtype(dtype), "white": white,
                    "black": black}
    else:
        _tls.amp = None
    try:
        yield
    finally:
        _tls.amp = prev


amp_guard = auto_cast


def _cast_float(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    if v.is_floating_point() and v.dtype != dt:
        return v.to(dt)
    return v


def _to_fp32(vals) -> List[torch.Tensor]:
    return [v.to(torch.float32) if v.dtype in _LOW else v for v in vals]


def amp_cast_inputs(op_name: str, vals) -> List[torch.Tensor]:
    """The inputs ``vals`` of op ``op_name`` cast by the active policy."""
    st = amp_state()
    if st is None:
        return list(vals)
    dt = st["dtype"]
    if st["level"] == "O2":
        if op_name in st["black"]:
            return _to_fp32(vals)
        return [_cast_float(v, dt) for v in vals]
    if op_name in st["white"]:
        return [_cast_float(v, dt) for v in vals]
    if op_name in st["black"]:
        return _to_fp32(vals)
    return list(vals)


def cast(op_name: str, *vals: torch.Tensor):
    """A cast point: ``vals`` as op ``op_name`` takes them (a tuple),
    untouched when no amp is active."""
    if amp_state() is None:
        return vals
    return tuple(amp_cast_inputs(op_name, list(vals)))


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at O2 every fp32 parameter of the model(s)
    is cast to ``dtype`` in place. Returns the model(s), with the
    optimizer(s) when given."""
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = _dtype(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in torch_parameters(m):
                    if p.dtype == torch.float32:
                        p.data = p.data.to(dt)
    out = model_list[0] if single else model_list
    if optimizers is None:
        return out
    return out, optimizers


class GradScaler:
    """``paddle.amp.GradScaler`` (dynamic loss scaling).

    ``scale(loss)`` multiplies the loss; ``step(opt)`` unscales the
    gradients (each replaced by its fp32 product, as the reference's
    ``unscale_`` leaves it; the optimizer casts it to the parameter's
    dtype for the update) and skips
    the update when one of them is not finite, shrinking the scale by
    ``decr_ratio`` after ``decr_every_n_nan_or_inf`` such steps (never
    below ``FLAGS_min_loss_scaling``), or updates and grows the scale by
    ``incr_ratio`` after ``incr_every_n_steps`` good steps in a row."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        # True while the last step() skipped its update for an inf/nan
        self.last_step_skipped = False
        # reads of the device's finite flag by the host, one a step
        self.host_reads = 0
        # tensors whose gradient unscale_ widened to fp32 (framework/grads.py)
        self._widened = []

    def _restore_grad_dtypes(self):
        """A widened tensor whose gradient other code cleared (``p.grad =
        None``) makes its own dtype again at the next backward, as the
        reference's does."""
        self._widened = [t for t in self._widened if restore_grad_dtype(t)]

    def scale(self, loss):
        self._restore_grad_dtypes()
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale, once per step: each
        replaced by the fp32 product ``g * (1 / scale)``, as the
        reference's (an fp32 gradient in place; an fp16 or bf16 one
        widened, ``framework/grads.py``). Whether one is not finite is
        gathered on the device, over the unscaled fp32 values, and read by
        the host once (the reference reads it a parameter)."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameter_list:
            p = getattr(p, "_value", p)     # an eager Parameter's payload
            if p.grad is not None:
                g = p.grad.to(torch.float32) * inv
                finite.append(torch.isfinite(g).all())
                if p.grad.dtype != torch.float32:
                    self._widened.append(p)
                hold_grad(p, g)
        self._found_inf = bool(finite) and not bool(
            torch.stack(finite).all())
        self.host_reads += bool(finite)
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            self.last_step_skipped = False
            return
        self.unscale_(optimizer)       # a no-op if the caller unscaled
        self.last_step_skipped = self._found_inf
        if self._found_inf:
            self._on_bad_step()
        else:
            optimizer.step()
            self._on_good_step()
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, *args, **kwargs):
        """The caller ran ``scaled.backward()``: unscale, step, update."""
        self.step(optimizer)
        self.update()

    def update(self):
        # the state moves in step(); a gradient cleared since gets its
        # parameter's dtype back
        self._restore_grad_dtypes()

    def _on_good_step(self):
        if not self._dynamic:
            return
        self._good_steps += 1
        self._bad_steps = 0
        if self._good_steps >= self._incr_every:
            self._scale *= self._incr_ratio
            self._good_steps = 0

    def _on_bad_step(self):
        if not self._dynamic:
            return
        self._bad_steps += 1
        self._good_steps = 0
        if self._bad_steps >= self._decr_every:
            self._scale = max(self._scale * self._decr_ratio,
                              float(flag("FLAGS_min_loss_scaling")))
            self._bad_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)

    set_state_dict = load_state_dict
