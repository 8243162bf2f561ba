"""Losses (reference: ``paddle_tpu/nn/functional/loss.py``): every loss
of the reference's, ``hsigmoid_loss``, ``class_center_sample``,
``margin_cross_entropy`` and ``center_loss`` among them (their
docstrings say what each keeps from the reference). Each is a cast
point of ``amp`` under the reference's op name (the hinge-embedding,
cosine-embedding, triplet and log losses under the reference's empty
name), and each follows the reference's formula:

- ``cross_entropy`` has every option of the reference's: class
  ``weight``, ``ignore_index``, ``reduction`` ("mean", "sum", "none"),
  ``soft_label``, ``axis``, ``use_softmax`` (False: the input holds
  probabilities, ``log`` of them clamped at 1e-30) and
  ``label_smoothing``. It computes in fp32 whatever the input's dtype
  (on amp's black list: bf16 inputs are cast to fp32). With hard
  labels, positions labelled ``ignore_index`` count 0; the mean divides
  by the number of other positions (at least 1), or with a ``weight`` by
  the sum of their classes' weights (at least 1e-12). A label of shape
  ``[..., 1]`` is squeezed along ``axis``. ``nll_loss`` picks along
  axis 1 with the same rules; ``softmax_with_cross_entropy`` keeps the
  label's trailing axis (``unsqueeze``).
- ``binary_cross_entropy(p, y)`` clamps ``p`` to ``[1e-12, 1 - 1e-12]``;
  ``binary_cross_entropy_with_logits`` is the stable ``max(z, 0) - z y
  + logaddexp(0, -|z|)``, with ``pos_weight`` ``(1 - y) z + ((pos_weight
  - 1) y + 1) (logaddexp(0, -|z|) + max(-z, 0))``; ``sigmoid_focal_loss``
  weighs that ``ce`` by ``a_t (1 - p_t)^gamma``, divided by
  ``normalizer``, summed by default.
- ``kl_div``'s "mean" is over every element, "batchmean" over the first
  axis; ``y (log(max(y, 1e-12)) - x)``. ``smooth_l1_loss`` is the
  reference's Huber form times ``delta``.
- A hinge is ``maximum(., 0)`` (half the gradient at 0, as ``jnp``'s).
- A float input that only selects (the embedding losses' and
  ``npair_loss``'s labels) gets a zero gradient, as the reference's
  ``call_op`` gives every floating input one.
- ``ctc_loss`` applies ``log_softmax`` to its ``[T, B, C]`` input
  itself, warpctc-style, and runs the alpha recursion in log space
  over the blank-interleaved labels, each sequence frozen past its
  input length. Unreachable states hold the reference's ``-1e30``, so an
  impossible alignment gives a large finite loss, not ``inf``. "mean"
  divides each loss by its label length first.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...amp import cast
from ...framework.autograd import link
from ...tensor import unsqueeze

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "smooth_l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "ctc_loss", "sigmoid_focal_loss",
           "soft_margin_loss", "poisson_nll_loss", "gaussian_nll_loss",
           "multi_margin_loss", "dice_loss", "npair_loss", "rank_loss",
           "bpr_loss", "hsigmoid_loss", "class_center_sample",
           "margin_cross_entropy", "center_loss"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _zero(v: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=v.dtype, device=v.device)


def _hinge(v: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(v, 0)``: half the gradient at 0."""
    return torch.maximum(v, _zero(v))


def _logaddexp0(v: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(_zero(v), v)


def _log_sigmoid(v: torch.Tensor) -> torch.Tensor:
    return -_logaddexp0(-v)


def _pick(logp, ids, axis, ignore_index, weight, reduction, smoothing=0.0):
    """The hard-label loss of ``cross_entropy`` and ``nll_loss``."""
    mask = ids != ignore_index
    safe = torch.where(mask, ids, torch.zeros_like(ids))
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if smoothing > 0:
        loss = (-(1 - smoothing) * picked
                + smoothing * -logp.mean(axis))
    else:
        loss = -picked
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    loss = torch.where(mask, loss, zero)
    if weight is not None:
        wsel = torch.where(mask, weight[safe].to(loss.dtype), zero)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return loss.sum() / mask.to(loss.dtype).sum().clamp_min(1.0)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    logits, lbl, *w = cast("cross_entropy", input, label,
                           *(() if weight is None else (weight,)))
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
    return _pick(logp, ids.to(torch.int64), axis, ignore_index,
                 w[0] if w else None, reduction, label_smoothing)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    from .activation import softmax

    loss = cross_entropy(logits, label, reduction="none",
                         soft_label=soft_label, ignore_index=ignore_index,
                         axis=axis)
    if not soft_label:
        loss = unsqueeze(loss, axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    a, b = cast("mse_loss", input, label)
    return _reduce((a - b) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    a, b = cast("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    a, b = cast("smooth_l1_loss", input, label)
    d = a - b
    loss = torch.where(d.abs() < delta, 0.5 * d * d / delta,
                       d.abs() - 0.5 * delta)
    return _reduce(loss * delta, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    logp, ids, *w = cast("nll_loss", input, label,
                         *(() if weight is None else (weight,)))
    return _pick(logp, ids.to(torch.int64), 1, ignore_index,
                 w[0] if w else None, reduction)


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
    zero = _zero(z)
    soft = torch.logaddexp(zero, -z.abs())
    if pw is not None:
        log_w = (pw - 1) * y + 1
        loss = (1 - y) * z + log_w * (soft + torch.maximum(-z, zero))
    else:
        loss = torch.maximum(z, zero) - z * y + soft
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    logp, y = cast("kl_div", input, label)
    loss = y * (torch.log(y.clamp_min(1e-12)) - logp)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    a, b, y = cast("margin_ranking_loss", input, other, label)
    return _reduce(_hinge(-y * (a - b) + margin), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    x, y = cast("", input, label)
    loss = torch.where(y == 1.0, x, _hinge(margin - x))
    return _reduce(link(loss, y), reduction)


def _norm(v, dim):
    return torch.sqrt((v * v).sum(dim))


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    a, b, y = cast("", input1, input2, label)
    cos = (a * b).sum(-1) / torch.maximum(
        _norm(a, -1) * _norm(b, -1), torch.full((), 1e-12, dtype=a.dtype,
                                                device=a.device))
    loss = torch.where(y == 1, 1 - cos, _hinge(cos - margin))
    return _reduce(link(loss, y), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = cast("", input, positive, negative)

    def dist(u, v):
        return ((u - v).abs() ** p).sum(-1) ** (1 / p)

    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce(_hinge(dp - dn + margin), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    p, y = cast("", input, label)
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


def square_error_cost(input, label):
    a, b = cast("square_error_cost", input, label)
    return (a - b) ** 2


NEG = -1e30     # the reference's log-space "unreachable"


class _LogAddExp(torch.autograd.Function):
    """``jnp.logaddexp`` with JAX's gradient, ``exp(x - out)`` for each
    input. Where ``out`` absorbed the smaller term (two unreachable
    states at -1e30) the two weights sum past 1, where PyTorch's own
    rule shares 1; an impossible alignment's gradient is the
    reference's that way."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_lae = _LogAddExp.apply


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``[T, B, C]`` logits, ``[B, L]`` padded labels and ``[B]``
    lengths (module docstring)."""
    lp, lab, in_len, lab_len = cast("ctc_loss", log_probs, labels,
                                    input_lengths, label_lengths)
    T, B, _ = lp.shape
    L = lab.shape[1]
    dev = lp.device
    logp = torch.log_softmax(lp.to(torch.float32), dim=-1)
    S = 2 * L + 1
    t_len = in_len.to(torch.long).reshape(B, 1)
    l_len = lab_len.to(torch.long).reshape(B, 1)
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab.to(torch.long)
    s_idx = torch.arange(S, device=dev)
    valid = s_idx < 2 * l_len + 1
    can_skip = ((s_idx % 2 == 1) & (s_idx >= 2)
                & (ext != torch.roll(ext, 2, dims=1)))
    neg = torch.full((), NEG, device=dev)
    emit0 = logp[0].gather(1, ext)
    alpha = torch.full((B, S), NEG, device=dev)
    alpha = torch.cat([emit0[:, :1],
                       torch.where(l_len > 0, emit0[:, 1:2], neg),
                       alpha[:, 2:]], 1)
    pad1 = torch.full((B, 1), NEG, device=dev)
    pad2 = torch.full((B, 2), NEG, device=dev)
    for t in range(1, T):
        from1 = torch.cat([pad1, alpha[:, :-1]], 1)
        from2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1),
                            neg)
        merged = _lae(_lae(alpha, from1), from2)
        new = torch.where(valid, merged + logp[t].gather(1, ext), neg)
        alpha = torch.where(t < t_len, new, alpha)
    end1 = alpha.gather(1, (2 * l_len).clamp_min(0))
    end2 = torch.where(l_len > 0,
                       alpha.gather(1, (2 * l_len - 1).clamp_min(0)), neg)
    loss = -_lae(end1, end2).reshape(B)
    if norm_by_times:
        loss = loss / t_len.reshape(B).to(torch.float32).clamp_min(1.0)
    if reduction == "mean":
        return (loss / l_len.reshape(B).to(torch.float32).clamp_min(1.0)
                ).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y, *rest = cast("sigmoid_focal_loss", logit, label,
                       *(() if normalizer is None else (normalizer,)))
    zero = _zero(z)
    p = torch.sigmoid(z)
    ce = torch.maximum(z, zero) - z * y + torch.logaddexp(zero, -z.abs())
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if rest:
        loss = loss / rest[0]
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    x, y = cast("soft_margin_loss", input, label)
    return _reduce(torch.log1p(torch.exp(-y.to(x.dtype) * x)), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    x, y = cast("poisson_nll_loss", input, label)
    if log_input:
        loss = torch.exp(x) - y * x
    else:
        loss = x - y * torch.log(x + epsilon)
    if full:
        y1 = y.clamp_min(1.0)
        stirling = y * torch.log(y1) - y + 0.5 * torch.log(2 * math.pi * y1)
        loss = loss + torch.where(y > 1, stirling, _zero(stirling))
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    mu, y, var = cast("gaussian_nll_loss", input, label, variance)
    v = var.clamp_min(epsilon)
    loss = 0.5 * (torch.log(v) + (y - mu) ** 2 / v)
    if full:
        loss = loss + 0.5 * math.log(float(torch.tensor(2 * math.pi,
                                                        dtype=mu.dtype)))
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    x, y, *w = cast("multi_margin_loss", input, label,
                    *(() if weight is None else (weight,)))
    c = x.shape[1]
    y = y.to(torch.long)
    correct = x.gather(1, y.reshape(-1, 1))
    m = _hinge(margin - correct + x) ** p
    if w:
        m = m * w[0][None, :]
    other = torch.ones_like(x).scatter(1, y.reshape(-1, 1), 0.0)
    return _reduce((m * other).sum(1) / c, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2 |X n Y| / (|X| + |Y|) over all but the batch axis, averaged."""
    pred, lbl = cast("dice_loss", input, label)
    oh = (lbl.reshape(lbl.shape[:-1]).unsqueeze(-1) == torch.arange(
        pred.shape[-1], device=pred.device)).to(pred.dtype)
    red = tuple(range(1, pred.dim()))
    inter = (pred * oh).sum(red)
    union = pred.sum(red) + oh.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    a, p, lbl = cast("npair_loss", anchor, positive, labels)
    lab = lbl.reshape(-1)
    sim = a @ p.T
    tgt = (lab[:, None] == lab[None, :]).to(sim.dtype)
    tgt = tgt / tgt.sum(-1, keepdim=True).clamp_min(1.0)
    ce = -(tgt * torch.log_softmax(sim, -1)).sum(-1).mean()
    reg = l2_reg * ((a * a).sum(-1).mean() + (p * p).sum(-1).mean()) * 0.25
    return link(ce + reg, lbl)


def rank_loss(label, left, right, name=None):
    t, l, r = cast("rank_loss", label, left, right)
    o = l - r
    return _logaddexp0(o) - t * o


def bpr_loss(input, label, name=None):
    lg, lbl = cast("bpr_loss", input, label)
    _, c = lg.shape
    y = lbl.reshape(-1, 1).to(torch.long)
    diff = lg.gather(1, y) - lg
    mask = torch.ones_like(lg).scatter(1, y, 0.0)
    return (-(_log_sigmoid(diff) * mask).sum(-1) / (c - 1)).reshape(-1, 1)


# ------------------------------------------------- the last four losses
def _simple_code(lbl: torch.Tensor, num_classes: int, depth: int):
    """The default tree's paths (the reference's SimpleCode): class ``c``
    is the leaf ``c + C`` of a heap-indexed complete tree; at level ``i``
    its node is ``(leaf >> (i + 1)) - 1`` and its branch bit ``(leaf >>
    i) & 1``, -1 past the root."""
    c = lbl.reshape(-1).to(torch.int64) + num_classes
    tables, codes = [], []
    minus = torch.full((), -1, dtype=torch.int64, device=c.device)
    for i in range(depth):
        parent = c >> (i + 1)
        valid = parent >= 1
        tables.append(torch.where(valid, parent - 1, minus))
        codes.append(torch.where(valid, (c >> i) & 1, minus))
    return torch.stack(tables, -1), torch.stack(codes, -1)


def _host_path(v, device) -> torch.Tensor:
    """A custom ``path_table``/``path_code`` (a tensor or host data) as
    int64 on ``device``."""
    v = getattr(v, "_value", v)
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v))
    return v.to(device=device, dtype=torch.int64)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: each sample's loss is the sum of the binary
    logistic losses along its class's path, ``[B, 1]``; ``weight``'s row
    ``j`` is node ``j``'s. The default tree is the complete binary tree
    of ``num_classes`` leaves; a custom one comes as ``path_table``
    (node ids, -1 padding) and ``path_code`` (branch bits). ``is_sparse``
    is taken and not used."""
    C = int(num_classes)
    depth = max(int(np.ceil(np.log2(max(C, 2)))) + 1, 1)
    if bias is None:
        x, lbl, w = cast("hsigmoid_loss", input, label, weight)
    else:
        x, lbl, w, bias = cast("hsigmoid_loss", input, label, weight, bias)
    if path_table is not None:
        pt = _host_path(path_table, x.device)
        pc = _host_path(path_code, x.device)
    else:
        pt, pc = _simple_code(lbl, C, depth)
    logit = torch.einsum("bd,bld->bl", x, w[pt])
    if bias is not None:
        logit = logit + bias.reshape(-1)[pt]
    ll = _log_sigmoid(torch.where(pc == 1, logit, -logit))
    per = -torch.sum(torch.where(pc >= 0, ll, _zero(ll)), -1)
    return per.reshape(-1, 1)


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampling: every class in ``label`` and, up to
    ``num_samples`` classes in all, others drawn without replacement by
    numpy's global generator (so ``np.random.seed`` repeats a draw), in
    sorted order after the positives. Returns the labels remapped to
    their index in the sample, and the sampled classes. ``group`` is
    taken and not used (the model-parallel form: ROADMAP Queue A 10)."""
    v = label._value if hasattr(label, "_value") else label
    lbl = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
           else np.asarray(v))
    flat = lbl.reshape(-1)
    pos = np.unique(flat)
    n_extra = max(int(num_samples) - pos.size, 0)
    rest = np.setdiff1d(np.arange(int(num_classes)), pos)
    if n_extra > 0 and rest.size:
        extra = np.random.choice(rest, min(n_extra, rest.size),
                                 replace=False)
        sampled = np.concatenate([pos, np.sort(extra)])
    else:
        sampled = pos
    remap = {int(c): i for i, c in enumerate(sampled)}
    new_lbl = np.asarray([remap[int(c)] for c in flat], np.int64)
    device = v.device if isinstance(v, torch.Tensor) else None
    return (torch.from_numpy(new_lbl.reshape(lbl.shape)).to(device),
            torch.from_numpy(sampled.astype(np.int64)).to(device))


class _UnitClip(torch.autograd.Function):
    """``jnp.clip(x, -1, 1)`` with JAX's gradient: the incoming gradient
    multiplied by 1 inside, 1/2 at a bound and 0 outside, so that a NaN
    from ``arccos`` at the bound stays NaN (PyTorch's ``minimum`` and
    ``maximum`` select, and give 0 there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, -1.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo = torch.clamp(x, min=-1.0)
        inner = torch.where(x > -1, 1.0, torch.where(x == -1, 0.5, 0.0))
        outer = torch.where(lo < 1, 1.0, torch.where(lo == 1, 0.5, 0.0))
        return g * outer.to(g.dtype) * inner.to(g.dtype)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """The combined-margin softmax loss (ArcFace, CosFace, SphereFace):
    the label's cosine ``cos(t)``, clipped to ``[-1, 1]`` (half the
    gradient at a bound), becomes ``cos(m1 t + m2) - m3`` before the
    scaled softmax cross entropy. ``arccos``'s gradient is infinite at
    +-1: a logit there gives the reference's ``inf``/``nan`` gradient.
    ``group`` is taken and not used (ROADMAP Queue A 10)."""
    lg, lbl = cast("margin_cross_entropy", logits, label)
    ids = lbl.reshape(-1).to(torch.int64)
    cos = _UnitClip.apply(lg)
    tgt = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    oh = torch.nn.functional.one_hot(ids, lg.shape[-1]).to(lg.dtype)
    logp = torch.log_softmax((cos * (1 - oh) + tgt * oh) * scale, -1)
    nll = -logp.gather(-1, ids[:, None])[:, 0]
    if reduction in ("mean", "sum"):
        out = _reduce(nll, reduction)
    else:
        out = nll.reshape(-1, 1)
    return (out, torch.exp(logp)) if return_softmax else out


def center_loss(input, label, centers, alpha=0.1, update_center=True,
                name=None):
    """``0.5 |x - c_y|^2`` a sample, ``[B, 1]``. With ``update_center``
    each class in ``label`` moves its center by ``alpha`` times the sum
    of ``c - x`` over its samples divided by ``1 +`` their count, in
    place on ``centers``' device, after the loss read the old centers."""
    v, lbl, ctr = cast("center_loss", input, label, centers)
    y = lbl.reshape(-1).to(torch.int64)
    diff = v - ctr[y]
    out = 0.5 * torch.sum(diff * diff, -1, keepdim=True)
    if update_center:
        with torch.no_grad():
            old = centers.detach().to(torch.float32)
            sums = torch.zeros_like(old).index_add_(
                0, y, old[y] - v.detach().to(torch.float32))
            count = torch.bincount(y, minlength=old.shape[0])
            delta = sums / (1.0 + count.to(torch.float32))[:, None]
            centers.copy_((old - alpha * delta).to(centers.dtype))
    return out
