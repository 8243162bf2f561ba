"""Fused functionals (reference: ``paddle_tpu/incubate/nn/functional.py``
``fused_linear_cross_entropy``, :167-329).

    loss = fused_linear_cross_entropy(h, word_embeddings, labels,
                                      vocab_chunk=8192,
                                      transposed_weight=True)

The cross-entropy of ``x @ weight (+ bias)`` without the whole ``[N, V]``
logits: the vocabulary is taken ``vocab_chunk`` columns at a time. Each
chunk is one fp32 GEMM (``torch.matmul``, as the reference leaves its
chunk products to XLA) into one reused ``[N, C]`` buffer, then one
``ce_chunk_fwd`` launch (``ops/fused_ce.py``) folds it into the running
logsumexp and picks the label's logit. The backward recomputes each
chunk from the saved logsumexp (it keeps none of the forward's chunks):
one ``ce_chunk_bwd`` launch turns it into ``(softmax - onehot) * g`` in
place, then ``dx += dlogit @ W_c^T`` and ``dW_c = x^T @ dlogit``, written
into its rows (``transposed_weight``) or columns of one fp32 ``dW``.

Where the reference pads the vocabulary to the chunk grid and masks the
padding to ``-inf``, the port's last chunk is ragged: ``V - start``
columns, the same sums and no GEMM work on padding.

Precision. The chunk GEMMs run at the settings of the weight's model
dtype (``framework/precision.py``: TF32 for a bf16 table's fp32
products, off for fp32), entered by the forward around its GEMMs and,
for the backward, by this function's node, the first of its backward
pass, through ``enter_for_backward``: the rest of the pass (the GPT
blocks' GEMMs) runs at those settings, and the caller's are back when
the pass ends, as the logits' identity node does for the unfused loss
(``framework/precision.py`` ``backward_precision``). ``dx`` is returned in
``x``'s dtype, ``dW`` in the weight's (a bf16 table's gradient rounded
once from fp32, before it meets any other gradient of the table) and
``db`` in the bias's, as the reference casts them.

The function is a cast point of ``amp`` under the reference's op name,
"fused_linear_cross_entropy" (x, weight, bias and labels).

The reference's other fused functionals (``fused_multi_head_attention``,
``fused_feedforward``, ``fused_linear``, ``fused_linear_activation``)
are not ported yet (ROADMAP Queue A, "incubate functionals").
"""
from __future__ import annotations

import torch

from ...amp import cast
from ...framework.precision import (enter_for_backward, matmul_precision,
                                    settings_for)
from ...ops.fused_ce import ce_chunk_bwd, ce_chunk_fwd

__all__ = ["fused_linear_cross_entropy"]

_REDUCTIONS = ("mean", "sum", "none")


def _w_chunk(weight, start: int, c: int, transposed: bool):
    """The chunk's fp32 weight: rows ``[C, H]`` of a ``[V, H]`` table
    (``transposed``), else columns ``[H, C]`` of ``[H, V]``."""
    w = weight[start:start + c] if transposed else weight[:, start:start + c]
    return w.to(torch.float32)


def _b_chunk(bias, start: int, c: int):
    if bias is None:
        return None
    return bias[start:start + c].to(torch.float32).contiguous()


def _chunk_logits(xf, wc, transposed: bool, buf, c: int):
    """``xf @ W_c`` [N, C] in fp32, into the front of ``buf``."""
    out = buf[:xf.shape[0] * c].view(xf.shape[0], c)
    return torch.matmul(xf, wc.t() if transposed else wc, out=out)


class _ChunkedLinearCE(torch.autograd.Function):
    """Per-position loss ``lse - picked`` [N] of ``x @ W (+ b)`` over
    chunks of the vocabulary (reference ``_core`` with its custom VJP)."""

    @staticmethod
    def forward(ctx, x, weight, bias, labels, chunk: int, transposed: bool):
        prec = settings_for(weight.dtype)
        xf = x.to(torch.float32)
        n, dev = xf.shape[0], xf.device
        v = weight.shape[0 if transposed else 1]
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        s = torch.zeros(n, dtype=torch.float32, device=dev)
        picked = torch.zeros(n, dtype=torch.float32, device=dev)
        buf = torch.empty(n * min(chunk, v), dtype=torch.float32, device=dev)
        with matmul_precision(prec):
            for start in range(0, v, chunk):
                c = min(chunk, v - start)
                logit = _chunk_logits(
                    xf, _w_chunk(weight, start, c, transposed), transposed,
                    buf, c)
                ce_chunk_fwd(logit, _b_chunk(bias, start, c), labels, start,
                             v, m, s, picked)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, weight, bias, labels, lse)
        ctx.chunk, ctx.transposed, ctx.prec = chunk, transposed, prec
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, labels, lse = ctx.saved_tensors
        enter_for_backward(ctx.prec)
        chunk, transposed = ctx.chunk, ctx.transposed
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        xf = x.to(torch.float32)
        gf = g.to(torch.float32).contiguous()
        n, h, dev = xf.shape[0], xf.shape[1], xf.device
        v = weight.shape[0 if transposed else 1]
        f32 = dict(dtype=torch.float32, device=dev)
        dx = torch.zeros(n, h, **f32) if need_x else None
        dw = (torch.empty((v, h) if transposed else (h, v), **f32)
              if need_w else None)
        db = torch.empty(v, **f32) if need_b else None
        buf = torch.empty(n * min(chunk, v), **f32)
        for start in range(0, v, chunk):
            c = min(chunk, v - start)
            wc = _w_chunk(weight, start, c, transposed)
            dlogit = _chunk_logits(xf, wc, transposed, buf, c)
            ce_chunk_bwd(dlogit, _b_chunk(bias, start, c), lse, labels, gf,
                         start)
            if need_x:
                dx.addmm_(dlogit, wc if transposed else wc.t())
            if need_w and transposed:
                torch.matmul(dlogit.t(), xf, out=dw[start:start + c])
            elif need_w:
                dw[:, start:start + c] = xf.t() @ dlogit
            if need_b:
                db[start:start + c] = dlogit.sum(0)
        return (dx.to(x.dtype) if need_x else None,
                dw.to(weight.dtype) if need_w else None,
                db.to(bias.dtype) if need_b else None, None, None, None)


def fused_linear_cross_entropy(x, weight, labels, bias=None,
                               vocab_chunk=8192, reduction="mean",
                               ignore_index=-100, transposed_weight=False,
                               name=None):
    """Cross-entropy over ``x @ weight (+ bias)`` without the whole
    logits (module docstring). ``x``: [N, H] (or [..., H], flattened);
    ``weight``: [H, V] (Linear layout), or [V, H] with
    ``transposed_weight`` (a tied embedding); ``labels``: [N] integers.
    Positions labelled ``ignore_index`` count 0 and are left out of the
    mean's count (which is at least 1); a label outside ``[0, V)`` gives
    NaN at its position. Returns the reduced loss, or [N] with
    ``reduction='none'``."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    x, weight, *rest = cast("fused_linear_cross_entropy", x, weight,
                            *(() if bias is None else (bias,)), labels)
    bias, labels = (None, rest[0]) if bias is None else rest
    v = int(weight.shape[0 if transposed_weight else -1])
    chunk = min(int(vocab_chunk), v)
    if chunk < 1:
        raise ValueError(f"vocab_chunk must be >= 1, got {vocab_chunk}")
    x2 = x.reshape(-1, x.shape[-1])
    lbl = labels.reshape(-1).to(torch.int32)
    safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl), lbl)
    per = _ChunkedLinearCE.apply(x2, weight, bias, safe.contiguous(), chunk,
                                 bool(transposed_weight))
    mask = lbl != ignore_index
    # a label outside [0, V) falls in no chunk: its picked logit would stay
    # 0 and inflate the loss silently, so it reads NaN instead
    oob = mask & ((lbl < 0) | (lbl >= v))
    per = torch.where(oob, torch.full_like(per, float("nan")),
                      torch.where(mask, per, torch.zeros_like(per)))
    if reduction == "mean":
        return per.sum() / mask.to(torch.float32).sum().clamp_min(1.0)
    if reduction == "sum":
        return per.sum()
    return per
