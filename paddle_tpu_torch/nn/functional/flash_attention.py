"""The public fused-attention entry (reference:
``paddle_tpu/nn/functional/flash_attention.py``): ``flash_attention``,
``flash_attn_unpadded``, and ``scaled_dot_product_attention``
re-exported.

Layout ``[batch, seq, heads, head_dim]`` in and out, as the reference's.
The route is the reference's ``_use_kernel`` (``:23-28``): with
``dropout == 0`` and a shape that the flash kernels take
(``ops/flash_attention.py`` ``flash_attention_supported``, equal q, k
and v shapes), a CUDA tensor goes to ``flash_attention_val``, the
ported flash kernels (``flash_fwd``/``flash_dq``/``flash_dkv`` and their
bf16 and fp16 forms), as the op "flash_attention". Everything else goes to
``scaled_dot_product_attention``, whose dropout draws from the device's
generator (``common.py``). A CPU tensor takes that route too, as the
reference's off-TPU route does; under ``flash_route()`` it takes the
kernels' plain versions instead, as the card computes it.

``return_softmax=True`` raises ``ValueError`` (the kernels never build
the probabilities). ``flash_attn_unpadded`` serves equal lengths only
(``NotImplementedError`` otherwise), as the reference's does, and, as
the reference's, ignores its ``scale`` argument: the scale is ``1 /
sqrt(head_dim)`` (ROADMAP Queue C).
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp import cast
from ...ops.flash_attention import flash_attention_supported, flash_attention_val
from .attention import _tls, scaled_dot_product_attention

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention"]


def _use_kernel(q, k, v, dropout) -> bool:
    if dropout != 0.0 or not q.shape == k.shape == v.shape:
        return False
    if q.device.type == "cuda":
        return flash_attention_supported(tuple(q.shape))
    return getattr(_tls, "flash", False) and q.dim() == 4


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """Returns ``(out, None)``: the flash route never builds the
    probabilities."""
    if return_softmax:
        raise ValueError("return_softmax=True is unsupported: flash "
                         "attention never materializes the probability "
                         "matrix")
    if _use_kernel(query, key, value, dropout):
        q, k, v = cast("flash_attention", query, key, value)
        return flash_attention_val(q, k, v, causal=causal), None
    return scaled_dot_product_attention(
        query, key, value, attn_mask=None, dropout_p=dropout,
        is_causal=causal, training=training), None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False, name=None):
    """Packed ``[total, heads, head_dim]`` sequences of equal length, run
    as a ``[b, s, heads, head_dim]`` batch; ``scale`` is not read."""
    cu = cu_seqlens_q
    lens = np.diff(np.asarray(cu.cpu() if isinstance(cu, torch.Tensor)
                              else cu))
    if len(set(lens.tolist())) != 1:
        raise NotImplementedError(
            "flash_attn_unpadded requires equal sequence lengths (pad the "
            "batch), as the reference's does")
    s, b = int(lens[0]), len(lens)

    def batched(t):
        (t,) = cast("unpad_reshape", t)
        return t.reshape(b, s, *t.shape[1:])

    out, _ = flash_attention(batched(query), batched(key), batched(value),
                             dropout=dropout, causal=causal)
    (out,) = cast("unpad_flatten", out)
    return out.reshape(b * s, *out.shape[2:]), None
