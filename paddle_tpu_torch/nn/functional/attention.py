"""Scaled dot-product attention (reference:
``paddle_tpu/nn/functional/attention.py`` ``scaled_dot_product_attention``).

Layout ``[batch, seq, heads, head_dim]``, as the reference's. Unmasked,
dropout-free attention with equal q/k/v shapes on CUDA tensors that the
flash kernel takes goes to ``ops/flash_attention.py``
``flash_attention_val`` (the reference routes the same case to its Pallas
flash kernel on the TPU, ``attention.py:35-47``). Everything else, and
every CPU tensor, takes the reference's plain path (``:48-76``): scaled
logits, ``finfo.min`` where a causal or bool mask hides a key, a float
mask added, a max-subtracted softmax, then the product with ``v``.
"""
from __future__ import annotations

import math

import torch

from ...ops.flash_attention import flash_attention_supported, flash_attention_val
from .common import dropout as _dropout

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """q/k/v ``[b, s, n, d]`` -> ``[b, s, n, d]``. ``attn_mask``
    broadcasts against ``[b, n, q_len, kv_len]``; a bool mask keeps True
    positions, a float mask is added to the logits."""
    if (attn_mask is None and dropout_p == 0.0
            and query.shape == key.shape == value.shape
            and query.device.type == "cuda"
            and flash_attention_supported(tuple(query.shape))):
        return flash_attention_val(query, key, value, causal=is_causal)
    scale = 1.0 / math.sqrt(query.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", query, key) * scale
    lowest = torch.finfo(logits.dtype).min
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~keep, lowest)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, lowest)
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = (probs / probs.sum(-1, keepdim=True)).to(value.dtype)
    probs = _dropout(probs, dropout_p, training=training)
    return torch.einsum("bhqk,bkhd->bqhd", probs, value)
