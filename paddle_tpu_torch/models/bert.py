"""BERT for inference (reference: ``paddle_tpu/models/bert.py``
``BertConfig``, ``bert_presets``, ``BertEmbeddings``, ``BertPooler``,
``BertModel`` and ``BertForPretraining``).

The same modules and parameter names as the reference: embeddings (word,
position, token type, LayerNorm with ``layer_norm_eps``), a post-norm
``TransformerEncoder`` with exact-erf GELU, the tanh pooler over the
first token, and the pretraining heads: ``transform`` + GELU +
``transform_norm``, MLM logits tied to the word embedding
(``h @ W_emb.T + mlm_bias``, a plain ``torch.matmul``, as the reference
computes it outside any kernel) and the NSP ``Linear``. Unmasked
attention on the card runs the flash kernel; ``convert_to_int8`` turns
the model's 6 L + 3 ``Linear`` layers into int8 ones.

Parameters are drawn from ``np.random.RandomState(seed)``; ``mlm_bias``
starts at zero. The draws are not the reference's (which seeds from
Paddle's generator): weights are carried across with
``models/convert.py`` ``bert_state_dict_from_numpy``.

Not in this slice (each raises ``NotImplementedError``, ROADMAP Queue A
"BERT training"): ``masked_lm_labels`` (the MLM loss),
``fused_loss_chunk > 0``, ``BertPretrainingCriterion``, dropout > 0 in
training, and the tensor-parallel ``dist_spec`` marks.

Numerics: fp32, TF32 off for matmuls and cuDNN, entered by each
forward (``framework.precision.matmul_precision``), whatever the caller
set process-wide.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_device, to_device
from ..framework.precision import matmul_precision
from ..nn import functional as F
from ..nn.functional.common import TRAINING_ITEM
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["BertConfig", "bert_presets", "BertEmbeddings", "BertPooler",
           "BertModel", "BertForPretraining", "BertPretrainingCriterion"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.0
    attn_dropout: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0
    fused_loss_chunk: int = 0

    @property
    def ffn(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


_PRESETS = {
    "bert-test": dict(vocab_size=256, hidden_size=64, num_layers=2,
                      num_heads=4, max_position_embeddings=64),
    "bert-base": dict(),
    "bert-large": dict(hidden_size=1024, num_layers=24, num_heads=16),
}


def bert_presets(name: str, **overrides) -> BertConfig:
    cfg = dict(_PRESETS[name])
    cfg.update(overrides)
    return BertConfig(**cfg)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet ({TRAINING_ITEM})")


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        kw = dict(device=device, rs=rs)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        with torch.no_grad():
            for e in (self.word_embeddings, self.position_embeddings,
                      self.token_type_embeddings):
                e.weight.mul_(cfg.initializer_range)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps, device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, device=device,
                            rs=rs)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings -> TransformerEncoder -> pooler. Returns
    (sequence_output [b, s, H], pooled_output [b, H])."""

    def __init__(self, config: BertConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        self.config = config
        self.device = device
        self.embeddings = BertEmbeddings(config, rs, device)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_heads, config.ffn,
            dropout=config.dropout, activation="gelu",
            attn_dropout=config.attn_dropout, act_dropout=config.dropout,
            normalize_before=False, device=device, rs=rs)
        self.encoder = TransformerEncoder(enc_layer, config.num_layers, rs=rs)
        self.pooler = BertPooler(config, rs, device)

    def mark_tensor_parallel(self):
        """The reference's Megatron ``dist_spec`` marks."""
        raise _not_ported("tensor-parallel BERT (dist_spec marks)")

    def _ids(self, x):
        if x is None or isinstance(x, torch.Tensor) and x.device == self.device:
            return x
        return to_device(x, self.device, torch.long)

    @matmul_precision("float32")
    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and not isinstance(attention_mask,
                                                         torch.Tensor):
            attention_mask = torch.as_tensor(np.asarray(attention_mask),
                                             device=self.device)
        x = self.embeddings(self._ids(input_ids), self._ids(token_type_ids),
                            self._ids(position_ids))
        seq = self.encoder(x, src_mask=attention_mask)
        return seq, self.pooler(seq)


class BertForPretraining(nn.Module):
    """MLM head (transform + tied decoder) and NSP head."""

    def __init__(self, config: BertConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if config.fused_loss_chunk > 0:
            raise _not_ported("fused_loss_chunk (the chunked MLM loss)")
        self.device = resolve_device(device)
        self.config = config
        rs = np.random.RandomState(seed)
        h = config.hidden_size
        self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_size,
                                                 device=self.device))
        self.bert = BertModel(config, rs, self.device)
        self.transform = Linear(h, h, device=self.device, rs=rs)
        self.transform_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                        device=self.device)
        self.nsp = Linear(h, 2, device=self.device, rs=rs)

    @matmul_precision("float32")
    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_lm_labels=None):
        """(MLM logits [b, s, vocab], NSP logits [b, 2])."""
        if masked_lm_labels is not None:
            raise _not_ported("the MLM loss (masked_lm_labels)")
        dt = self.bert.embeddings.word_embeddings.weight.dtype
        if dt != torch.float32:
            raise NotImplementedError(
                f"BERT in {dt} is not ported yet (ROADMAP Queue A, "
                f"'bf16 BERT'); the port runs BERT in float32")
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        x = self.transform_norm(F.gelu(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings.weight
        return torch.matmul(x, w.T) + self.mlm_bias, self.nsp(pooled)


class BertPretrainingCriterion(nn.Module):
    """The reference's MLM + NSP loss: training, not ported yet."""

    def __init__(self):
        super().__init__()
        raise _not_ported("BertPretrainingCriterion")
