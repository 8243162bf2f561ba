"""A parameter's ``.grad`` held in a wider dtype than its own (no
reference file: PyTorch's rule, for the reference's behaviour).

``GradScaler.unscale_`` leaves each gradient as the reference leaves it,
the fp32 product ``g * (1 / scale)`` (``paddle_tpu/amp/__init__.py:161``),
also on an fp16 or bf16 parameter. PyTorch takes such a gradient only
when the tensor's ``grad_dtype`` allows it, and that can be set only
while ``.grad`` is None. The setting stays: a later backward accumulates
into the fp32 gradient, as the reference's ``grad + g`` promotes to fp32,
but a backward after the gradient is cleared would make fp32 too, where
the reference's makes the parameter's dtype. So the port puts
``grad_dtype`` back wherever it clears a gradient (``clear_grad``) and
where ``GradScaler`` finds one cleared by other code.
"""
from __future__ import annotations

import torch

__all__ = ["hold_grad", "clear_grad", "restore_grad_dtype"]


def hold_grad(t: torch.Tensor, g: torch.Tensor) -> None:
    """``t.grad`` becomes ``g``'s values in ``g``'s dtype: written in place
    when the gradient has that dtype (its storage stays, for a table that
    holds its pointer), else replaced, ``t.grad_dtype`` set to ``g``'s."""
    if t.grad is not None and t.grad.dtype == g.dtype:
        t.grad.copy_(g)
        return
    t.grad = None
    t.grad_dtype = g.dtype
    t.grad = g


def restore_grad_dtype(t: torch.Tensor) -> bool:
    """Once ``t.grad`` is gone, ``t``'s gradient dtype back to its own
    (the next backward makes that dtype). Returns True while ``t`` still
    holds a gradient of another dtype."""
    if getattr(t, "grad_dtype", t.dtype) == t.dtype:
        return False
    if t.grad is not None:
        return True
    t.grad_dtype = t.dtype
    return False


def clear_grad(t: torch.Tensor) -> None:
    """``t.grad = None``, its gradient dtype back to its own."""
    t.grad = None
    restore_grad_dtype(t)
