"""GEMM precision on the card, per model dtype (no reference file: new;
XLA takes a precision per op where cuBLAS reads process-wide flags).

``matmul_precision(dtype)`` sets PyTorch's cuBLAS and cuDNN flags for a
model of ``dtype`` and restores the caller's on exit; it works as a
``with`` block or as a decorator. The models enter it themselves, so
what a caller set process-wide does not change their numerics: each
forward inside a ``with`` block, and the backward through the first
node of its pass, which calls ``enter_for_backward``: the identity node
that ``backward_precision`` puts on a model's outputs (GPT's logits;
BERT's MLM loss or logits with its NSP logits), or the fused loss's own
node (``incubate/nn/functional.py``). The settings are entered as the
backward pass starts and the caller's restored when the pass ends,
successful or raising (``RestoreAtEnd``); a node that enters settings
again later in the same pass (BERT's fused loss under the model's node)
changes them for the rest of the pass, and the first entry's restore
undoes both:

- "float32": TF32 off for matmuls, so an fp32 product on the card is
  an fp32 product, as the reference computes it;
- "bfloat16": TF32 on for fp32 matmuls (the bf16 GPT's one fp32 GEMM,
  the LM head; ``models/gpt.py`` says why);
- "float16": the same for the fp16 GPT, whose LM head is the same fp32
  GEMM of the final norm's output and the fp16 table promoted.

All three turn cuDNN's TF32 off, and cuBLAS's reduced-precision
reductions for bf16 and fp16 GEMMs (both on by PyTorch's default, and
with the fp16 one on cuBLAS may sum fp16 products in fp16): XLA sums
bf16 and fp16 products in fp32, split-K partial sums included. Under ``amp`` a model keeps the
settings of its parameters' dtype: BERT's fp32 masters enter "float32",
which runs the bf16 (or fp16) GEMMs that amp's casts make without the
reduced-precision reduction and the fp32 ones it leaves (O1's MLM loss) in full
fp32, as the reference computes each. GPT enters the settings of the
dtype its operands have after amp's cast (``settings_for``): under O2
its blocks and LM head are bf16 GEMMs and enter "bfloat16" (fp16
ones, under ``dtype="float16"``, "float16").

The flags are read on the host when a GEMM is launched; they do nothing
on the CPU.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["matmul_precision", "settings_for", "RestoreAtEnd",
           "enter_for_backward", "backward_precision"]

# dtype -> torch.backends.cuda.matmul.allow_tf32
_TF32 = {"float32": False, "bfloat16": True, "float16": True}
_SETTINGS = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


def settings_for(dtype: torch.dtype) -> str:
    """The settings' name for a model's operands of ``dtype``: its
    parameters', or those amp's casts give them."""
    return _SETTINGS.get(dtype, "float32")


class matmul_precision(contextlib.ContextDecorator):
    """The card's GEMM settings for a model of ``dtype`` (module
    docstring) inside the ``with`` block or the decorated call."""

    def __init__(self, dtype: str):
        if dtype not in _TF32:
            raise ValueError(f"no GEMM settings for dtype={dtype!r}")
        self.dtype = dtype
        self._saved = []

    def __enter__(self):
        mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
        self._saved.append((mm.allow_tf32,
                            mm.allow_bf16_reduced_precision_reduction,
                            mm.allow_fp16_reduced_precision_reduction,
                            dnn.allow_tf32))
        mm.allow_tf32 = _TF32[self.dtype]
        mm.allow_bf16_reduced_precision_reduction = False
        mm.allow_fp16_reduced_precision_reduction = False
        dnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
        (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         mm.allow_fp16_reduced_precision_reduction,
         dnn.allow_tf32) = self._saved.pop()
        return False


# settings entered by ``enter_for_backward`` and not yet left, in order
_entered = []


class RestoreAtEnd:
    """Leaves an entered ``matmul_precision`` once, with every setting
    entered for backward after it (newest first). The engine calls it at
    the end of a backward pass that succeeds (a final callback, as DDP
    queues its own; callbacks run in the order they were queued, so the
    pass's first entry leaves them all and the later ones find theirs
    gone). When a node raises, the engine runs no final callback, but it
    frees the pass's queued callbacks with the pass, and that frees this
    object: ``__del__`` leaves the settings then, before ``backward()``
    hands the error to its caller."""

    def __init__(self, settings: matmul_precision):
        self._settings = settings

    def __call__(self):
        settings, self._settings = self._settings, None
        if settings is None or not any(s is settings for s in _entered):
            return
        while _entered:
            done = _entered.pop()
            done.__exit__(None, None, None)
            if done is settings:
                break

    __del__ = __call__


def enter_for_backward(dtype: str) -> None:
    """From inside a backward node: enter ``matmul_precision(dtype)`` for
    the rest of the running backward pass and leave it when the pass
    ends (``RestoreAtEnd``), whether it succeeds or raises."""
    settings = matmul_precision(dtype)
    settings.__enter__()
    _entered.append(settings)
    torch.autograd.Variable._execution_engine.queue_callback(
        RestoreAtEnd(settings))


class _EnterForBackward(torch.autograd.Function):
    """Identity on its tensors; its backward enters the settings."""

    @staticmethod
    def forward(ctx, dtype, *xs):
        ctx.dtype = dtype
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *dys):
        enter_for_backward(ctx.dtype)
        return (None, *dys)


def backward_precision(dtype: str, *xs):
    """``xs`` behind one identity node whose backward, the first node of
    a backward pass from them, enters ``matmul_precision(dtype)`` for the
    GEMMs of that pass (``enter_for_backward``). Returns the tensor, or
    the tuple for several; without a gradient, ``xs`` as they are."""
    if any(x.requires_grad for x in xs):
        xs = _EnterForBackward.apply(dtype, *xs)
    return xs[0] if len(xs) == 1 else tuple(xs)
