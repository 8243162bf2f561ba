"""Weights carried across from the JAX model (no reference file: new).

The caller extracts the JAX ``GPTForCausalLM``'s named parameters as
numpy arrays (``{name: np.asarray(p._value)}``); this module turns them
into the port's ``state_dict``. The names are the same on both sides,
so the mapping checks names and shapes and copies the bytes unchanged.
The port itself never sees JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .gpt import GPTConfig, block_shapes

__all__ = ["expected_shapes", "state_dict_from_numpy"]


def expected_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Parameter name -> shape, in the reference's naming."""
    h = cfg.hidden_size
    out = {
        "gpt.embeddings.word_embeddings": (cfg.vocab_size, h),
        "gpt.embeddings.position_embeddings":
            (cfg.max_position_embeddings, h),
    }
    for i in range(cfg.num_layers):
        for name, shape in block_shapes(cfg).items():
            out[f"gpt.decoder.{i}.{name}"] = shape
    out["gpt.final_norm.weight"] = (h,)
    out["gpt.final_norm.bias"] = (h,)
    return out


def state_dict_from_numpy(params: Dict[str, np.ndarray],
                          cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """JAX named parameters (numpy) -> the port's ``state_dict`` (CPU
    fp32 tensors; ``load_state_dict`` moves them to the model's device)."""
    want = expected_shapes(cfg)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(params[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        if arr.dtype != np.float32:
            raise TypeError(f"{name}: dtype {arr.dtype}, expected float32")
        out[name] = torch.from_numpy(np.array(arr, copy=True))
    return out
