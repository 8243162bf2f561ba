"""Eager dispatch and gradients (reference: ``paddle_tpu/framework/autograd.py``).

The reference records a tape of its own: ``call_op`` takes ``jax.vjp``
of each op over its differentiable inputs and ``run_backward`` walks the
recorded nodes. The port's payload is a ``torch.Tensor``, so PyTorch's
autograd is that tape: an op on tensors that require gradients records
its node, and ``backward()`` is ``torch.autograd.backward``.

- ``call_op(fn, *args, op_name=)`` is the counterpart of the
  reference's: it unwraps the eager ``Tensor`` arguments, runs the amp
  cast point under the reference's op name (``amp.cast``), calls ``fn``
  on the ``torch.Tensor``s and wraps the result. It wraps only when an
  argument was a ``Tensor``: given plain ``torch.Tensor``s (the models'
  path) it returns plain ``torch.Tensor``s.
- Which outputs get gradients is the reference's rule
  (``autograd.py:472-493``): floating outputs of an op with a
  differentiable input. PyTorch's ``requires_grad`` propagates the same
  way, and ``Tensor.stop_gradient`` reads it.
- An op that reads an input only for its shape (``zeros_like``,
  ``pad_constant_like``'s ``x``) still records a node there, and the
  input's gradient is zeros: ``_Link`` does the same here.
- ``.grad`` lands on leaves only, as the reference's ``_deposit`` puts
  it only on a tensor that had no producing node when the op ran
  (``autograd.py:829-840``); an in-place op that rebinds a leaf keeps
  the leaf for ``.grad`` (``framework/tensor.py``).
- ``no_grad``, ``enable_grad``, ``set_grad_enabled`` and
  ``is_grad_enabled`` are PyTorch's (thread-local, context manager and
  decorator, as the reference's).
"""
from __future__ import annotations

import functools

import torch
from torch import enable_grad, is_grad_enabled, no_grad, set_grad_enabled

from .. import amp as _amp
from .dtype import NARROW

__all__ = ["call_op", "eager_fn", "wrap", "unwrap", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "grad", "run_backward"]

_Tensor = None      # framework.tensor.Tensor, bound when that module loads
_new = object.__new__


def wrap(v: torch.Tensor):
    """``v`` as an eager ``Tensor``, 64-bit dtypes narrowed as the
    reference holds them (``framework/dtype.py``)."""
    d = NARROW.get(v.dtype)
    if d is not None:
        v = v.to(d)
    t = _new(_Tensor)
    t._value = v
    return t


def wrap_outputs(out, inputs=()):
    """An op's result wrapped: a tensor, or a tuple of them. An output
    that is one of the input tensors themselves becomes a view of it, so
    that the two wrappers keep their own ``stop_gradient``."""
    if isinstance(out, torch.Tensor):
        for v in inputs:
            if out is v:
                out = out.view_as(out)
                break
        return wrap(out)
    if isinstance(out, (tuple, list)):
        return tuple(wrap_outputs(o, inputs) for o in out)
    return out


class _Link(torch.autograd.Function):
    """``out`` unchanged, linked to ``inputs`` with a zero gradient."""

    @staticmethod
    def forward(ctx, out, *inputs):
        ctx.shapes = [(v.shape, v.dtype, v.device) for v in inputs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.shapes])


def link(out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """``out`` with a zero-gradient edge to each input that needs one."""
    live = [v for v in inputs if v.requires_grad]
    return _Link.apply(out, *live) if live else out


def _linked(out, inputs):
    if (isinstance(out, torch.Tensor) and not out.requires_grad
            and out.is_floating_point() and torch.is_grad_enabled()):
        return link(out, *inputs)
    return out


def call_op(fn, *args, op_name: str = ""):
    """Dispatch ``fn`` on the payloads of ``args`` through the cast point
    ``op_name`` (module docstring)."""
    wrapped = False
    vals = list(args)
    pos = []
    for i, a in enumerate(args):
        if isinstance(a, _Tensor):
            vals[i] = a._value
            wrapped = True
            pos.append(i)
        elif isinstance(a, torch.Tensor):
            pos.append(i)
    if _amp.amp_state() is not None:
        cast = _amp.cast(op_name, *[vals[i] for i in pos])
        for i, c in zip(pos, cast):
            vals[i] = c
    out = fn(*vals)
    if not wrapped:
        return out
    inputs = [vals[i] for i in pos]
    return wrap_outputs(_linked(out, inputs), inputs)


def unwrap(x):
    """An eager ``Tensor``'s payload; anything else as it is."""
    return x._value if isinstance(x, _Tensor) else x


def eager_fn(fn):
    """``fn``, a function of ``torch.Tensor``s that runs its own cast
    points (the ``nn.functional`` ops), taking eager ``Tensor``s too:
    given one anywhere in its arguments it gets their payloads and its
    result is wrapped, as ``call_op``'s; given none it is ``fn``. A
    function wrapped already is returned as it is."""
    if getattr(fn, "_eager", False):
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not any(isinstance(a, _Tensor) for a in args) and not any(
                isinstance(v, _Tensor) for v in kwargs.values()):
            return fn(*args, **kwargs)
        args = [unwrap(a) for a in args]
        kwargs = {k: unwrap(v) for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        inputs = [a for a in (*args, *kwargs.values())
                  if isinstance(a, torch.Tensor)]
        return wrap_outputs(_linked(out, inputs), inputs)

    run._eager = True
    return run


def run_backward(tensors, grad_tensors=None, retain_graph=False):
    """``Tensor.backward``: gradients of ``tensors`` into the leaves'
    ``.grad``. A tensor that needs no gradient contributes nothing, as in
    the reference (whose walk finds no node to visit)."""
    outs, grads = [], []
    for k, t in enumerate(tensors):
        v = t._value
        g = None if grad_tensors is None else unwrap(grad_tensors[k])
        if g is None and v.numel() != 1:
            raise RuntimeError(
                "backward() on a non-scalar Tensor requires grad_tensors")
        if not v.requires_grad:
            continue
        outs.append(v)
        grads.append(torch.ones_like(v) if g is None else g.to(v.dtype))
    if outs:
        torch.autograd.backward(outs, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` (a list, one entry per input, ``None`` where an input is
    unused and ``allow_unused``), without touching ``.grad``.
    ``retain_graph`` defaults to False, as in the reference."""
    single = isinstance(outputs, _Tensor)
    outputs = [outputs] if single else list(outputs)
    inputs = [inputs] if isinstance(inputs, _Tensor) else list(inputs)
    if grad_outputs is not None and isinstance(grad_outputs, _Tensor):
        grad_outputs = [grad_outputs]
    outs, gouts = [], []
    for k, t in enumerate(outputs):
        v = t._value
        g = None if grad_outputs is None else unwrap(grad_outputs[k])
        if g is None and v.numel() != 1:
            raise RuntimeError(
                "grad() of a non-scalar output requires grad_outputs")
        if v.requires_grad:
            outs.append(v)
            gouts.append(torch.ones_like(v) if g is None else g)
    live = [i for i, t in enumerate(inputs) if t._value.requires_grad]
    found = [None] * len(inputs)
    if outs and live:
        res = torch.autograd.grad(
            outs, [inputs[i]._value for i in live], gouts,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, res):
            found[i] = None if g is None else wrap(g)
    if not allow_unused and any(g is None for g in found):
        raise RuntimeError(
            "One of the differentiated Tensors appears to not have been "
            "used in the graph (set allow_unused=True to allow)")
    return found
