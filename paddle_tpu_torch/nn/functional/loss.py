"""Cross-entropy (reference: ``paddle_tpu/nn/functional/loss.py``
``cross_entropy``, :20-66).

Every option of the reference's: class ``weight``, ``ignore_index``,
``reduction`` ("mean", "sum", "none"), ``soft_label``, ``axis``,
``use_softmax`` (False: the input holds probabilities, ``log`` of them
clamped at 1e-30) and ``label_smoothing``. It computes in fp32 whatever
the input's dtype, and is a cast point of ``amp`` under
"cross_entropy" (on the black list: bf16 inputs are cast to fp32).

With hard labels, positions labelled ``ignore_index`` count 0; the mean
divides by the number of other positions (at least 1), or with a
``weight`` by the sum of their classes' weights (at least 1e-12). A
label of shape ``[..., 1]`` is squeezed along ``axis``.
"""
from __future__ import annotations

import torch

from ...amp import cast

__all__ = ["cross_entropy"]


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
