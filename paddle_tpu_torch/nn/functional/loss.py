"""Losses (reference: ``paddle_tpu/nn/functional/loss.py``
``cross_entropy``, :20-66; ``binary_cross_entropy`` and
``binary_cross_entropy_with_logits``, :128-160).

``cross_entropy`` has every option of the reference's: class ``weight``,
``ignore_index``, ``reduction`` ("mean", "sum", "none"), ``soft_label``,
``axis``, ``use_softmax`` (False: the input holds probabilities, ``log``
of them clamped at 1e-30) and ``label_smoothing``. It computes in fp32
whatever the input's dtype, and is a cast point of ``amp`` under
"cross_entropy" (on the black list: bf16 inputs are cast to fp32).

With hard labels, positions labelled ``ignore_index`` count 0; the mean
divides by the number of other positions (at least 1), or with a
``weight`` by the sum of their classes' weights (at least 1e-12). A
label of shape ``[..., 1]`` is squeezed along ``axis``.

``binary_cross_entropy(p, y)`` clamps ``p`` to ``[1e-12, 1 - 1e-12]``
and takes ``-(y log p + (1 - y) log(1 - p))``;
``binary_cross_entropy_with_logits(z, y)`` is the reference's stable
form ``max(z, 0) - z y + logaddexp(0, -|z|)``, and with ``pos_weight``
``(1 - y) z + ((pos_weight - 1) y + 1) (logaddexp(0, -|z|) + max(-z,
0))``; both multiply by ``weight`` and reduce by ``reduction``, and are
cast points of ``amp`` under the reference's op names
("binary_cross_entropy", "bce_with_logits"; on neither list).
"""
from __future__ import annotations

import torch

from ...amp import cast

__all__ = ["cross_entropy", "binary_cross_entropy",
           "binary_cross_entropy_with_logits"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    logits, lbl, *w = cast("cross_entropy", input, label,
                           *(() if weight is None else (weight,)))
    w = w[0] if w else None
    x = logits.to(torch.float32)
    if use_softmax:
        logp = torch.log_softmax(x, dim=axis)
    else:
        logp = torch.log(x.clamp_min(1e-30))
    if soft_label:
        soft = lbl.to(torch.float32)
        if label_smoothing > 0:
            k = logits.shape[axis]
            soft = (1 - label_smoothing) * soft + label_smoothing / k
        return _reduce(-(soft * logp).sum(axis), reduction)
    ids = lbl
    if ids.dim() == logp.dim():             # the [..., 1] form
        ids = ids.squeeze(axis)
    ids = ids.to(torch.int64)
    mask = ids != ignore_index
    safe = torch.where(mask, ids, torch.zeros_like(ids))
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        smooth = -logp.mean(axis)
        loss = -(1 - label_smoothing) * picked + label_smoothing * smooth
    else:
        loss = -picked
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    loss = torch.where(mask, loss, zero)
    if w is not None:
        wsel = torch.where(mask, w[safe].to(torch.float32), zero)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / mask.to(torch.float32).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p, y, *w = cast("binary_cross_entropy", input, label,
                    *(() if weight is None else (weight,)))
    p = p.clamp(1e-12, 1.0 - 1e-12)
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if w:
        loss = loss * w[0]
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    extra = [t for t in (weight, pos_weight) if t is not None]
    z, y, *rest = cast("bce_with_logits", logit, label, *extra)
    w = rest.pop(0) if weight is not None else None
    pw = rest[0] if pos_weight is not None else None
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    soft = torch.logaddexp(zero, -z.abs())
    if pw is not None:
        log_w = (pw - 1) * y + 1
        loss = (1 - y) * z + log_w * (soft + torch.maximum(-z, zero))
    else:
        loss = torch.maximum(z, zero) - z * y + soft
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)
