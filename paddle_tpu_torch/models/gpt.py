"""GPT configuration and parameters (reference: ``paddle_tpu/models/gpt.py``
``GPTConfig``, ``gpt_presets``, ``_block_shapes``, ``_block_init`` and the
``__init__`` of ``GPTEmbeddings``/``GPTDecoderLayer``/``GPTModel``/
``GPTForCausalLM``).

Parameters are drawn from ``np.random.RandomState(seed)`` in the
reference's order and with its standard deviations, so
``GPTForCausalLM(cfg, seed=s)`` equals the JAX model of the same seed,
converted, bit for bit. The parameter names are the reference's
(``gpt.embeddings.word_embeddings``, ``gpt.decoder.<i>.qkv_w``, ...).

The training ``forward`` is not part of this slice: serving reads the
parameters through ``serving.model.GPTDecodeModel``.

Numerics: fp32 throughout, and TF32 is switched off for matmuls and
cuDNN so a float32 product on the card is a float32 product.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..framework.device import resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["GPTConfig", "gpt_presets", "GPTEmbeddings", "GPTDecoderLayer",
           "GPTModel", "GPTForCausalLM", "BLOCK_PARAMS"]

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
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02

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


def _param(arr: np.ndarray, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(arr).to(device),
                        requires_grad=False)


class GPTEmbeddings(nn.Module):
    """Word + learned position embedding tables."""

    def __init__(self, cfg: GPTConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        std = cfg.initializer_range
        self.word_embeddings = _param(
            (rs.randn(cfg.vocab_size, cfg.hidden_size) * std
             ).astype("float32"), device)
        self.position_embeddings = _param(
            (rs.randn(cfg.max_position_embeddings, cfg.hidden_size) * std
             ).astype("float32"), device)


class GPTDecoderLayer(nn.Module):
    """One block's individually named parameters (``BLOCK_PARAMS``)."""

    def __init__(self, cfg: GPTConfig, rs: np.random.RandomState,
                 device: torch.device):
        super().__init__()
        for name, shape in block_shapes(cfg).items():
            setattr(self, name, _param(_block_init(name, shape, cfg, rs),
                                       device))


class GPTModel(nn.Module):
    """Embeddings, ``num_layers`` blocks and the final LayerNorm."""

    def __init__(self, config: GPTConfig, seed: int, device: torch.device):
        super().__init__()
        self.config = config
        rs = np.random.RandomState(seed)
        self.embeddings = GPTEmbeddings(config, rs, device)
        self.decoder = nn.ModuleList(
            [GPTDecoderLayer(config, rs, device)
             for _ in range(config.num_layers)])
        self.final_norm = nn.LayerNorm(
            config.hidden_size, eps=config.layer_norm_epsilon, device=device)
        self.final_norm.requires_grad_(False)


class GPTForCausalLM(nn.Module):
    """GPT with its LM head tied to the word embedding."""

    def __init__(self, config: GPTConfig, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, seed, self.device)
