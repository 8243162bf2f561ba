"""GPT configuration, parameters and training forward (reference:
``paddle_tpu/models/gpt.py`` ``GPTConfig``, ``gpt_presets``,
``_block_shapes``, ``_block_init``, ``_attention_val``, ``_block_apply``,
``GPTEmbeddings``/``GPTDecoderLayer``/``GPTModel``/``GPTForCausalLM``
and ``GPTPretrainingCriterion``).

Parameters are drawn from ``np.random.RandomState(seed)`` in the
reference's order and with its standard deviations, so
``GPTForCausalLM(cfg, seed=s)`` equals the JAX model of the same seed,
converted, bit for bit. The parameter names are the reference's
(``gpt.embeddings.word_embeddings``, ``gpt.decoder.<i>.qkv_w``, ...), and
all of them are trainable.

The forward is the reference's loop mode: embeddings, the blocks
(fp32 LayerNorm, packed qkv projection, causal attention, output
projection, tanh-gelu MLP, two residuals), the final LayerNorm and
logits tied to the word embedding. Attention is the flash kernel
(``ops/flash_attention.py``) with ``use_flash_attention`` (the default)
and the reference's einsum/softmax path without it. Serving reads the
same parameters through ``serving.model.GPTDecodeModel``.

``fused_loss_chunk > 0`` with ``labels`` returns the mean loss of the
chunked LM head instead of the logits
(``incubate.nn.functional.fused_linear_cross_entropy`` on the tied
table): the ``[b*s, V]`` logits never exist whole. ``recompute`` runs
each block under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): its activations are recomputed in the backward,
at the forward's GEMM settings, so the gradients are the same bits.

Not in this slice (each raises ``NotImplementedError``, see ROADMAP
Queue A "training options" and "parallelism"): dropout > 0 in training,
``recompute_policy``, ``mode="scan"`` and the pipeline, ring and Ulysses
attention; a ``dtype`` other than "float32" and "bfloat16".

Mixed precision is the reference's ``paddle.amp``
(``paddle_tpu_torch/amp``): each op of the forward is a cast point under
the reference's op name ("gpt_embed", dropout's "clone", "gpt_block",
the final norm's "layer_norm", "gpt_logits", "gpt_loss"; with
``fused_loss_chunk`` the two "reshape"s and
"fused_linear_cross_entropy"). Under ``auto_cast(level="O2")`` the
embedding, every block and the logits run in bf16 on the fp32
parameters (the final norm in fp32, on the black list); under O1 no GPT
op is on the white list and nothing changes. A block casts outside its
``recompute`` checkpoint, so the recompute in the backward runs on the
same cast tensors.

Numerics, per the dtype of the operands after amp's cast
(``framework.precision.matmul_precision``, ``settings_for``). Each
block enters the settings of its parameters' dtype around its forward
(and so around its recompute), the LM head those of the table's, and
the logits carry an identity node
(``framework.precision.backward_precision``) that enters the LM head's
settings for the backward pass that starts there, restored when that
pass ends. So the numerics are the same whoever runs the backward
(``TrainStep`` or a bare ``loss.backward()``) and whatever the caller
set process-wide:

- fp32 operands: fp32 throughout; TF32 off, so a float32 product on the
  card is a float32 product.
- bf16 operands (``dtype="bfloat16"``, or amp's O2 casts of an fp32
  model), as the reference stores and computes them: under
  ``dtype="bfloat16"`` the block parameters and both embedding tables in
  bf16 (rounded to nearest even from the fp32 draws), the final
  LayerNorm in fp32 (a generic layer).
  A block's LayerNorm takes its affine in fp32 and rounds once
  (``block_layer_norm``, the reference's ``_block_apply`` ``ln``); the
  final norm rounds before its fp32 affine and so returns fp32, and the
  LM head multiplies that by the bf16 table promoted to fp32, as jnp
  promotes ``h @ wv.T`` (under O2 both are cast to bf16 first: a bf16
  GEMM, bf16 logits). Two precision
  choices: (1) the LM head's fp32 GEMM runs in TF32 on the card. The
  reference's chip ran it at XLA's default precision, which on a TPU is
  one bf16 pass; TF32 keeps more operand bits than that, and full fp32
  would put ~1.9 TFLOP a step (GPT-125M, 8 x 1024 tokens, forward and
  backward) on the SIMT cores. (2) cuBLAS's reduced-precision reduction
  for bf16 GEMMs (``allow_bf16_reduced_precision_reduction``, on by
  default) is off: XLA sums bf16 products in fp32, split-K partial sums
  included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tensor as T
from ..amp import cast
from ..framework.device import resolve_device
from ..framework.precision import (backward_precision, matmul_precision,
                                   settings_for)
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..nn.functional import dropout, layer_norm
from ..ops.flash_attention import flash_attention_val

__all__ = ["GPTConfig", "gpt_presets", "GPTEmbeddings", "GPTDecoderLayer",
           "GPTModel", "GPTForCausalLM", "GPTPretrainingCriterion",
           "BLOCK_PARAMS", "PORTED_DTYPES"]

BLOCK_PARAMS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
                "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 1024
    dropout: float = 0.0
    attn_dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    mode: str = "loop"
    recompute: bool = False
    # per-layer activation policy ("none" | "remat" | "offload"); None
    # defers to ``recompute``
    recompute_policy: Optional[tuple] = None
    sequence_parallel: bool = False
    use_ring_attention: bool = False
    use_ulysses_attention: bool = False
    use_flash_attention: bool = True
    pp_microbatches: int = 0  # pipeline micro-batches (0 = pipe degree)
    fused_loss_chunk: int = 0
    dtype: str = "float32"

    def __post_init__(self):
        if self.use_ring_attention and self.use_ulysses_attention:
            raise ValueError(
                "use_ring_attention and use_ulysses_attention are mutually "
                "exclusive sequence-parallel schemes: pick one")
        if self.recompute_policy is not None:
            pol = tuple(self.recompute_policy)
            bad = [p for p in pol if p not in ("none", "remat", "offload")]
            if bad:
                raise ValueError(
                    f"recompute_policy entries must be one of "
                    f"none/remat/offload, got {bad}")
            if self.num_layers % max(1, len(pol)):
                raise ValueError(
                    f"recompute_policy length {len(pol)} does not tile "
                    f"num_layers={self.num_layers}")
            self.recompute_policy = pol

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


_PRESETS = {
    "gpt-test": dict(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_position_embeddings=128),
    "gpt-125m": dict(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_position_embeddings=1024),
    "gpt-350m": dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                     num_heads=16, max_position_embeddings=1024),
    "gpt-760m": dict(vocab_size=50304, hidden_size=1536, num_layers=24,
                     num_heads=16, max_position_embeddings=2048),
    "gpt-1.3b": dict(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_position_embeddings=2048),
}


def gpt_presets(name: str, **overrides) -> GPTConfig:
    cfg = dict(_PRESETS[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


def block_shapes(cfg: GPTConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer parameter shapes; qkv packed as [h, 3(q|k|v), h]."""
    h, f = cfg.hidden_size, cfg.ffn
    return {
        "ln1_w": (h,), "ln1_b": (h,),
        "qkv_w": (h, 3, h), "qkv_b": (3, h),
        "out_w": (h, h), "out_b": (h,),
        "ln2_w": (h,), "ln2_b": (h,),
        "fc1_w": (h, f), "fc1_b": (f,),
        "fc2_w": (f, h), "fc2_b": (h,),
    }


def _block_init(name: str, shape, cfg: GPTConfig,
                rs: np.random.RandomState) -> np.ndarray:
    if name.startswith("ln") and name.endswith("_w"):
        return np.ones(shape, dtype="float32")
    if name.endswith("_b"):
        return np.zeros(shape, dtype="float32")
    std = cfg.initializer_range
    if name in ("out_w", "fc2_w"):
        # GPT-2 residual-projection scaling: std / sqrt(2*L)
        std = std / math.sqrt(2.0 * cfg.num_layers)
    return (rs.randn(*shape) * std).astype("float32")


# GPTConfig.dtype -> the parameters' torch dtype
PORTED_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _param(arr: np.ndarray, device: torch.device,
           dtype: torch.dtype = torch.float32) -> nn.Parameter:
    """A parameter from fp32 draws, rounded to ``dtype`` (to nearest even,
    as the reference's ``Tensor(fp32, dtype=dt)``)."""
    return nn.Parameter(torch.from_numpy(arr).to(device=device, dtype=dtype))


_OPTIONS = "ROADMAP Queue A, 'training options'"
_PARALLEL = "ROADMAP Queue A, 'parallelism'"
_DTYPES = "ROADMAP Queue A, 'other dtypes'"


def _check_supported(cfg: GPTConfig) -> None:
    """Raise on the reference fields whose other values the port does not
    run; checked when the model is built."""
    if cfg.dtype not in PORTED_DTYPES:
        raise NotImplementedError(f"GPT dtype={cfg.dtype!r} is not ported "
                                  f"yet ({_DTYPES})")
    if cfg.recompute_policy is not None:
        raise NotImplementedError(f"recompute_policy is not ported yet "
                                  f"({_OPTIONS})")
    if cfg.sequence_parallel or cfg.pp_microbatches:
        raise NotImplementedError(f"sequence_parallel and pp_microbatches "
                                  f"are not ported yet ({_PARALLEL})")


def _check_trainable(cfg: GPTConfig, training: bool) -> None:
    """Raise on the configurations this slice's forward does not run."""
    if cfg.mode != "loop":
        raise NotImplementedError(f"GPT mode={cfg.mode!r} (scan/pipeline) is "
                                  f"not ported yet ({_PARALLEL})")
    if cfg.use_ring_attention or cfg.use_ulysses_attention:
        raise NotImplementedError(f"ring/Ulysses attention is not ported "
                                  f"yet ({_PARALLEL})")
    if training and (cfg.dropout > 0 or cfg.attn_dropout > 0):
        raise NotImplementedError(f"dropout > 0 in training is not ported "
                                  f"yet ({_OPTIONS})")


def attention(q, k, v, cfg: GPTConfig):
    """Causal attention on ``[b, s, n, d]`` (reference ``_attention_val``):
    the flash kernel, or with ``use_flash_attention=False`` the einsum /
    softmax path with ``finfo.min`` on masked logits."""
    if cfg.use_flash_attention:
        return flash_attention_val(q, k, v, causal=True)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    ql, kl = logits.shape[-2], logits.shape[-1]
    causal = torch.ones(ql, kl, dtype=torch.bool,
                        device=q.device).tril(kl - ql)
    logits = logits.masked_fill(~causal, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class GPTEmbeddings(nn.Module):
    """Word + learned position embedding tables."""

    def __init__(self, cfg: GPTConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        std = cfg.initializer_range
        dt = PORTED_DTYPES[cfg.dtype]
        self.word_embeddings = _param(
            (rs.randn(cfg.vocab_size, cfg.hidden_size) * std
             ).astype("float32"), device, dt)
        self.position_embeddings = _param(
            (rs.randn(cfg.max_position_embeddings, cfg.hidden_size) * std
             ).astype("float32"), device, dt)

    def forward(self, input_ids, position_ids=None):
        """Word plus position rows (op "gpt_embed"), in the dtype amp
        gives the tables: the rows are gathered from the tables as they
        are and cast at the cast point, the same values as rows of the
        cast tables, so the backward sums each row's gradients in the
        tables' dtype."""
        if position_ids is None:
            pos = self.position_embeddings[:input_ids.shape[-1]]
            ids = (input_ids,)
        else:
            pos = self.position_embeddings[position_ids]
            ids = (input_ids, position_ids)
        word, pos, *_ = cast("gpt_embed", self.word_embeddings[input_ids],
                             pos, *ids)
        return word + pos


def block_layer_norm(x, w, b, eps: float) -> torch.Tensor:
    """A block's LayerNorm over the last axis (reference ``_block_apply``
    ``ln``): statistics and affine in fp32, one rounding to ``x.dtype``.
    The generic ``layer_norm`` rounds before its affine; in fp32 the two
    are the same ops."""
    v = x.to(torch.float32)
    mean = v.mean(-1, keepdim=True)
    var = v.var(-1, keepdim=True, unbiased=False)
    out = (v - mean) * torch.rsqrt(var + eps)
    return (out * w + b).to(x.dtype)


class GPTDecoderLayer(nn.Module):
    """One block's individually named parameters (``BLOCK_PARAMS``)."""

    def __init__(self, cfg: GPTConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = PORTED_DTYPES[cfg.dtype]
        for name, shape in block_shapes(cfg).items():
            setattr(self, name, _param(_block_init(name, shape, cfg, rs),
                                       device, dt))

    def forward(self, x):
        """One block (reference ``_block_apply``, op "gpt_block") on
        ``[b, s, h]``, its input and parameters in the dtype amp gives
        them; with ``recompute`` its activations are recomputed in the
        backward from the same cast tensors."""
        x, *params = cast("gpt_block", x,
                          *(getattr(self, n) for n in BLOCK_PARAMS))
        if self.cfg.recompute and torch.is_grad_enabled():
            return checkpoint(self._block, x, *params, use_reentrant=False)
        return self._block(x, *params)

    def _block(self, x, *params):
        """The block at the GEMM settings of its parameters' dtype, which
        its recompute inside the backward pass would otherwise take from
        that pass."""
        cfg = self.cfg
        p = dict(zip(BLOCK_PARAMS, params))
        b, s, h = x.shape
        eps = cfg.layer_norm_epsilon
        with matmul_precision(settings_for(p["qkv_w"].dtype)):
            hn = block_layer_norm(x, p["ln1_w"], p["ln1_b"], eps)
            qkv = hn @ p["qkv_w"].reshape(h, 3 * h) + p["qkv_b"].reshape(3 * h)
            q, k, v = qkv.reshape(b, s, 3, cfg.num_heads,
                                  cfg.head_dim).unbind(2)
            attn = attention(q, k, v, cfg).reshape(b, s, h)
            x = x + (attn @ p["out_w"] + p["out_b"])
            hn = block_layer_norm(x, p["ln2_w"], p["ln2_b"], eps)
            z = F.gelu(hn @ p["fc1_w"] + p["fc1_b"], approximate="tanh")
            return x + (z @ p["fc2_w"] + p["fc2_b"])


class GPTModel(nn.Module):
    """Embeddings, ``num_layers`` blocks and the final LayerNorm."""

    def __init__(self, config: GPTConfig, seed: int, device: torch.device):
        super().__init__()
        _check_supported(config)
        self.config = config
        rs = np.random.RandomState(seed)
        self.embeddings = GPTEmbeddings(config, rs, device)
        self.decoder = nn.ModuleList(
            [GPTDecoderLayer(config, rs, device)
             for _ in range(config.num_layers)])
        self.final_norm = nn.LayerNorm(
            config.hidden_size, eps=config.layer_norm_epsilon, device=device)

    def forward(self, input_ids, position_ids=None):
        """Hidden states [b, s, h] after the final LayerNorm."""
        _check_trainable(self.config, self.training)
        x = self.embeddings(input_ids, position_ids)
        x = dropout(x, self.config.dropout, training=self.training)
        for blk in self.decoder:
            x = blk(x)
        fn = self.final_norm
        return layer_norm(x, x.shape[-1], fn.weight, fn.bias,
                          self.config.layer_norm_epsilon)


class GPTForCausalLM(nn.Module):
    """GPT with its LM head tied to the word embedding."""

    def __init__(self, config: GPTConfig, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, seed, self.device)

    def forward(self, input_ids, position_ids=None, labels=None):
        """Logits [b, s, vocab], tied to the word embedding; with
        ``labels`` and ``fused_loss_chunk > 0``, the mean loss of the
        chunked LM head instead (``labels`` is read only then, as in the
        reference)."""
        cfg = self.config
        x = self.gpt(input_ids, position_ids)
        w = self.gpt.embeddings.word_embeddings
        if labels is not None and cfg.fused_loss_chunk > 0:
            # the function's own node enters the GEMM settings for the
            # backward (no logits node here)
            return fused_linear_cross_entropy(
                T.reshape(x, [-1, cfg.hidden_size]), w,
                T.reshape(labels, [-1]), vocab_chunk=cfg.fused_loss_chunk,
                transposed_weight=True)
        x, w = cast("gpt_logits", x, w)
        prec = settings_for(w.dtype)
        with matmul_precision(prec):
            # jnp's promotion of ``h @ wv.T``: fp32 final-norm output times
            # the bf16 table is an fp32 GEMM; the gradient reaches the
            # table through the cast
            dt = torch.promote_types(x.dtype, w.dtype)
            logits = x.to(dt) @ w.to(dt).T
        return backward_precision(prec, logits)


class GPTPretrainingCriterion(nn.Module):
    """Mean LM loss in fp32: logsumexp minus the picked logit, averaged
    over the positions (or over ``loss_mask``'s weight, at least 1)."""

    def forward(self, prediction_scores, masked_lm_labels, loss_mask=None):
        lg, labels, *mask = cast(
            "gpt_loss", prediction_scores, masked_lm_labels,
            *(() if loss_mask is None else (loss_mask,)))
        lg = lg.to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        picked = lg.gather(-1, labels.long()[..., None])[..., 0]
        nll = lse - picked
        if mask:
            m = mask[0].to(torch.float32)
            return (nll * m).sum() / m.sum().clamp_min(1.0)
        return nll.mean()
