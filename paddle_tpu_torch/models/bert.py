"""BERT (reference: ``paddle_tpu/models/bert.py`` ``BertConfig``,
``bert_presets``, ``BertEmbeddings``, ``BertPooler``, ``BertModel``,
``BertForPretraining`` and ``BertPretrainingCriterion``).

The same modules and parameter names as the reference: embeddings (word,
position, token type, LayerNorm with ``layer_norm_eps``), a post-norm
``TransformerEncoder`` with exact-erf GELU, the tanh pooler over the
first token, and the pretraining heads: ``transform`` + GELU +
``transform_norm``, the MLM head tied to the word embedding
(``h @ W_emb.T + mlm_bias``, a plain ``torch.matmul``, as the reference
computes it outside any kernel) and the NSP ``Linear``. Unmasked
attention on the card runs the flash kernels; ``convert_to_int8`` turns
the model's 6 L + 3 ``Linear`` layers into int8 ones.

Training, as the reference's (``:175-256``): with ``masked_lm_labels``
the forward returns ``(mlm_loss, nsp_logits)``. Every negative label
marks an unmasked position (mapped to -1). The MLM loss is the op
"mlm_loss": logits ``h @ W_emb.T + b`` in the dtype amp gives its
inputs, then an fp32 logsumexp minus the picked logit, averaged over
the masked positions (at least 1); or with ``fused_loss_chunk > 0``
``incubate/nn/functional.py`` ``fused_linear_cross_entropy`` over the
tied table (``bias=mlm_bias``, ``ignore_index=-1``,
``transposed_weight=True``), the logits never whole. Without labels the
MLM logits are the op "mlm_logits". ``BertPretrainingCriterion`` is the
reference's MLM + NSP loss, with optional ``masked_lm_weights``.

Mixed precision is the reference's ``paddle.amp``
(``paddle_tpu_torch/amp``): every op on the path is a cast point under
the reference's op name (the functionals, the tensor ops of
``paddle_tpu_torch/tensor`` and the three loss ops here), so under
``auto_cast`` O1 or O2 the model casts where the reference casts, and
``decorate(level="O2")`` models run with bf16 parameters.
``BertConfig`` has no dtype, as in the reference.

Parameters are drawn from ``np.random.RandomState(seed)``; ``mlm_bias``
starts at zero. The draws are not the reference's (which seeds from
Paddle's generator): weights are carried across with
``models/convert.py`` ``bert_state_dict_from_numpy``.

Not ported (each raises ``NotImplementedError``, ROADMAP Queue A "BERT
training"): dropout > 0 in training, and the tensor-parallel
``dist_spec`` marks.

Numerics: the GEMM settings of fp32 parameters
(``framework.precision``: TF32 off, bf16 GEMMs without the reduced-
precision reduction), entered by each forward and, through one identity
node on the outputs (``backward_precision``), by the backward pass that
starts from them, whatever the caller set process-wide.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import tensor as T
from ..amp import cast
from ..framework.device import resolve_device, to_device
from ..framework.precision import backward_precision, matmul_precision
from ..incubate.nn.functional import fused_linear_cross_entropy
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
                e._parameters["weight"].mul_(cfg.initializer_range)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps, device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = T.unsqueeze(torch.arange(
                input_ids.shape[1], device=input_ids.device), 0)
        if token_type_ids is None:
            token_type_ids = T.zeros_like(input_ids)
        x = T.add(T.add(self.word_embeddings(input_ids),
                        self.position_embeddings(position_ids)),
                  self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, device=device,
                            rs=rs)

    def forward(self, hidden):
        return F.tanh(self.dense(T.getitem(hidden, (slice(None), 0))))


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


def _mlm_loss(h, w, b, labels):
    """The reference's op "mlm_loss": the mean over labels >= 0 of
    ``logsumexp - picked`` of ``h @ w.T + b``, in fp32 from logits in
    the inputs' dtype."""
    h, w, b, labels = cast("mlm_loss", h, w, b, labels)
    lg = (torch.matmul(h, w.T) + b).to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    mask = (labels >= 0).to(torch.float32)
    return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)


def _mlm_logits(x, w, b):
    """The reference's op "mlm_logits": ``x @ w.T + b``."""
    x, w, b = cast("mlm_logits", x, w, b)
    return torch.matmul(x, w.T) + b


class BertForPretraining(nn.Module):
    """MLM head (transform + tied decoder) and NSP head."""

    def __init__(self, config: BertConfig, seed: int = 0, device="cuda"):
        super().__init__()
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
        """(MLM logits [b, s, vocab], NSP logits [b, 2]), or with
        ``masked_lm_labels`` (MLM loss, NSP logits)."""
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        x = self.transform_norm(F.gelu(self.transform(seq)))
        w = self.bert.embeddings.word_embeddings._parameters["weight"]
        if masked_lm_labels is None:
            out = _mlm_logits(x, w, self.mlm_bias)
        else:
            lbl = T.reshape(self.bert._ids(masked_lm_labels), (-1,))
            lbl = T.where(T.less_than(lbl, 0), -1, lbl)
            h = T.reshape(x, (-1, self.config.hidden_size))
            if self.config.fused_loss_chunk > 0:
                out = fused_linear_cross_entropy(
                    h, w, lbl, bias=self.mlm_bias,
                    vocab_chunk=self.config.fused_loss_chunk,
                    ignore_index=-1, transposed_weight=True)
            else:
                out = _mlm_loss(h, w, self.mlm_bias, lbl)
        return backward_precision("float32", out, self.nsp(pooled))


class BertPretrainingCriterion(nn.Module):
    """The reference's MLM + NSP loss, the op "bert_pretraining_loss":
    the mean of ``logsumexp - picked`` over positions labelled >= 0
    (weighted by ``masked_lm_weights`` when given; the weights' sum, at
    least 1, divides), plus the mean NSP cross-entropy, in fp32."""

    def forward(self, prediction_scores, nsp_scores, masked_lm_labels,
                next_sentence_labels, masked_lm_weights=None):
        dev = prediction_scores.device

        def on(x, dtype):
            if isinstance(x, torch.Tensor) and x.device == dev:
                return x
            return to_device(x if isinstance(x, torch.Tensor)
                             else np.asarray(x), dev, dtype)

        args = [prediction_scores, nsp_scores,
                on(masked_lm_labels, torch.long),
                on(next_sentence_labels, torch.long)]
        if masked_lm_weights is not None:
            args.append(on(masked_lm_weights, torch.float32))
        lg, nsp, lbl, nsl, *w = cast("bert_pretraining_loss", *args)
        lg = lg.to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        picked = lg.gather(-1, lbl.clamp_min(0)[..., None])[..., 0]
        mask = (lbl >= 0).to(torch.float32)
        if w:
            mask = mask * w[0].to(torch.float32)
        mlm = ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)
        ns = nsp.to(torch.float32)
        ns_pick = ns.gather(-1, nsl.reshape(-1, 1))[..., 0]
        return mlm + (torch.logsumexp(ns, dim=-1) - ns_pick).mean()
