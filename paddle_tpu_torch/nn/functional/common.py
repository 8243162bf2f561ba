"""Linear and dropout functionals (reference:
``paddle_tpu/nn/functional/common.py`` ``linear`` and ``dropout``).

``linear`` keeps Paddle's weight layout ``[in_features, out_features]``:
``y = x @ W + b``. Dropout runs only at inference here, where it is the
identity: a positive rate in training raises (ROADMAP Queue A, "BERT
training"), and so do ``axis`` and ``mode="downscale_in_infer"`` (ROADMAP
Queue A, "Transformer family and ``nn`` options").
"""
from __future__ import annotations

import torch

__all__ = ["linear", "dropout", "check_dropout_options", "TRAINING_ITEM",
           "OPTIONS_ITEM"]

TRAINING_ITEM = "ROADMAP Queue A, 'BERT training'"
OPTIONS_ITEM = "ROADMAP Queue A, 'Transformer family and nn options'"


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``x @ weight + bias`` with ``weight`` as ``[in, out]``."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def check_dropout_options(axis, mode) -> None:
    """Only whole-tensor ``upscale_in_train`` dropout is ported."""
    if axis is not None or mode != "upscale_in_train":
        raise NotImplementedError(f"dropout axis={axis!r}, mode={mode!r} is "
                                  f"not ported yet ({OPTIONS_ITEM})")


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training=True,
            mode: str = "upscale_in_train") -> torch.Tensor:
    """Identity at inference; raises for a positive rate in training,
    which is not ported yet."""
    check_dropout_options(axis, mode)
    if p and training:
        raise NotImplementedError(f"dropout > 0 in training is not ported "
                                  f"yet ({TRAINING_ITEM})")
    return x
