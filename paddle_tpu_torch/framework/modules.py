"""PyTorch's meaning of a module's accessors, whatever the module.

An ``nn.Layer`` (``nn/layer/layers.py``) answers ``parameters()``,
``named_parameters()`` and ``buffers()`` as the reference does, with
eager views. The port's own code that wants the ``torch.Tensor``s
(``TrainStep``, ``DataParallel``, ``amp.decorate``, the weight
converters) reads them here, through the ``torch.nn.Module`` methods
themselves, for a ``Layer`` and a plain module alike.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["torch_parameters", "torch_named_parameters", "torch_buffers"]


def _members(module, store: str) -> List[Tuple[str, torch.Tensor]]:
    """Every module's ``store`` entries under their structured names,
    each tensor once (``torch.nn.Module.named_parameters``' walk; that
    method itself calls the overridden accessors)."""
    out, seen = [], set()
    for prefix, m in module.named_modules():
        for name, t in getattr(m, store).items():
            if t is None or id(t) in seen:
                continue
            seen.add(id(t))
            out.append((f"{prefix}.{name}" if prefix else name, t))
    return out


def torch_parameters(module) -> List[torch.Tensor]:
    return [t for _, t in _members(module, "_parameters")]


def torch_named_parameters(module) -> List[Tuple[str, torch.Tensor]]:
    return _members(module, "_parameters")


def torch_buffers(module, named: bool = False) -> list:
    out = _members(module, "_buffers")
    return out if named else [t for _, t in out]
