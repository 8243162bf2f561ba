"""Transformer encoder layers (reference:
``paddle_tpu/nn/layer/transformer.py`` ``_convert_attn_mask``,
``MultiHeadAttention``, ``TransformerEncoderLayer``,
``TransformerEncoder``).

Same constructor and forward contracts, on ``[batch, seq, embed_dim]``
with attention over ``[batch, seq, heads, head_dim]`` through
``functional.scaled_dot_product_attention`` (the flash kernel on the card
when unmasked). A bool mask becomes the reference's additive mask
``x * 1e4 - 1e4``. The head reshapes and the residual adds are the
reference's ops "reshape" and "add" (``paddle_tpu_torch/tensor``), cast
points of ``amp``. Each encoder layer's ``norm1``/``norm2`` use
LayerNorm's default epsilon 1e-5, whatever the model's own epsilon, as in
the reference (``transformer.py:136-137``).

Not ported yet (each raises ``NotImplementedError``; ROADMAP Queue A,
"Transformer family and ``nn`` options"): the incremental-decode caches
(``cache=``, ``gen_cache``), cross-attention widths ``kdim``/``vdim``,
``need_weights``, a final ``norm`` on ``TransformerEncoder``, activations
other than ``relu``/``gelu``, ``TransformerDecoderLayer``,
``TransformerDecoder`` and ``Transformer``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import tensor as T
from .. import functional as F
from ..functional.common import OPTIONS_ITEM
from .common import Dropout, Linear
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]

def _convert_attn_mask(mask, dtype):
    """Reference ``_convert_attention_mask``: a bool (or uint8) mask
    becomes an additive float mask, True -> 0, False -> -1e4."""
    if mask is None:
        return None
    if mask.dtype in (torch.bool, torch.uint8):
        return mask.to(dtype) * 1e4 - 1e4
    return mask


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet ({OPTIONS_ITEM})")


def _no_cache(cache) -> None:
    if cache is not None:
        raise _not_ported("the incremental-decode cache")


class MultiHeadAttention(Layer):
    """q/k/v/out projections around scaled dot-product attention."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim=None, vdim=None, need_weights: bool = False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 rs: Optional[np.random.RandomState] = None):
        super().__init__()
        if kdim not in (None, embed_dim) or vdim not in (None, embed_dim):
            raise _not_ported("MultiHeadAttention kdim/vdim")
        if need_weights:
            raise _not_ported("MultiHeadAttention need_weights")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        kw = dict(device=device, rs=rs)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _heads(self, x):
        return T.reshape(x, (x.shape[0], x.shape[1], self.num_heads,
                             self.head_dim))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        _no_cache(cache)
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(self.q_proj(query))
        k = self._heads(self.k_proj(key))
        v = self._heads(self.v_proj(value))
        mask = _convert_attn_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             dropout_p=self.dropout,
                                             training=self.training)
        return self.out_proj(T.reshape(out, (out.shape[0], out.shape[1],
                                             self.embed_dim)))


class TransformerEncoderLayer(Layer):
    """Self-attention and feed-forward blocks, each with a residual and a
    LayerNorm (post-norm unless ``normalize_before``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout=None, act_dropout=None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 rs: Optional[np.random.RandomState] = None):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise _not_ported(f"activation {activation!r}")
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, rs=rs)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, mode="upscale_in_train")
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.activation = getattr(F, activation)
        self._ctor = dict(d_model=d_model, nhead=nhead,
                          dim_feedforward=dim_feedforward, dropout=dropout,
                          activation=activation, attn_dropout=attn_dropout,
                          act_dropout=act_dropout,
                          normalize_before=normalize_before, device=device)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = T.add(residual, self.dropout1(self.self_attn(src, src, src,
                                                           src_mask)))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = T.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``encoder_layer`` followed by ``num_layers - 1`` fresh layers of the
    same configuration, drawn from ``rs``."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm=None, *,
                 rs: Optional[np.random.RandomState] = None):
        super().__init__()
        if norm is not None:
            raise _not_ported("TransformerEncoder norm")
        self.layers = nn.ModuleList(
            [encoder_layer] + [type(encoder_layer)(**encoder_layer._ctor,
                                                   rs=rs)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        return out
