"""Scaled dot-product attention (reference:
``paddle_tpu/nn/functional/attention.py`` ``scaled_dot_product_attention``).

Layout ``[batch, seq, heads, head_dim]``, as the reference's. Unmasked,
dropout-free attention with equal q/k/v shapes on CUDA tensors that the
flash kernel takes goes to ``ops/flash_attention.py``
``flash_attention_val`` (the reference routes the same case to its Pallas
flash kernel on the TPU, ``attention.py:35-47``), as the op
"sdpa_flash". Everything else, and every CPU tensor, takes the
reference's plain path (``:48-76``), as the ops "sdpa_probs" (scaled
logits, ``finfo.min`` where a causal or bool mask hides a key, a float
mask added, a max-subtracted softmax in the inputs' dtype) and
"sdpa_out" (the product with ``v``). Each op is a cast point of
``amp``.

``flash_route()`` sends CPU tensors down the flash route too, to the
kernels' plain versions (fp32 softmax inside, the output in the inputs'
dtype): a CPU run then computes what the card computes, as the
reference's ``force_target("tpu")`` does for its own route.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ...amp import cast
from ...ops.flash_attention import flash_attention_supported, flash_attention_val
from .common import dropout as _dropout

__all__ = ["scaled_dot_product_attention", "flash_route"]

_tls = threading.local()


@contextlib.contextmanager
def flash_route(enable: bool = True):
    """Inside the block (this thread), CPU tensors take the flash route
    when its conditions hold, through the kernels' plain versions."""
    prev = getattr(_tls, "flash", False)
    _tls.flash = enable
    try:
        yield
    finally:
        _tls.flash = prev


def _flash(query, key, value, attn_mask, dropout_p) -> bool:
    if attn_mask is not None or dropout_p != 0.0:
        return False
    if not query.shape == key.shape == value.shape:
        return False
    if query.device.type == "cuda":
        return flash_attention_supported(tuple(query.shape))
    return getattr(_tls, "flash", False) and query.dim() == 4


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """q/k/v ``[b, s, n, d]`` -> ``[b, s, n, d]``. ``attn_mask``
    broadcasts against ``[b, n, q_len, kv_len]``; a bool mask keeps True
    positions, a float mask is added to the logits."""
    if _flash(query, key, value, attn_mask, dropout_p):
        q, k, v = cast("sdpa_flash", query, key, value)
        return flash_attention_val(q, k, v, causal=is_causal)
    q, k, v, *mask = cast("sdpa_probs", query, key, value,
                          *(() if attn_mask is None else (attn_mask,)))
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lowest = torch.finfo(logits.dtype).min
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~keep, lowest)
    if mask:
        if mask[0].dtype == torch.bool:
            logits = torch.where(mask[0], logits, lowest)
        else:
            logits = logits + mask[0].to(logits.dtype)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = (probs / probs.sum(-1, keepdim=True)).to(v.dtype)
    if dropout_p:
        probs = _dropout(probs, dropout_p, training=training)
    probs, value = cast("sdpa_out", probs, value)
    return torch.einsum("bhqk,bkhd->bqhd", probs, value)
