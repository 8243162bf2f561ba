"""Linear, embedding and dropout functionals (reference:
``paddle_tpu/nn/functional/common.py`` ``linear``, ``embedding`` and
``dropout``).

``linear`` keeps Paddle's weight layout ``[in_features, out_features]``:
``y = x @ W + b``. Each is a cast point of ``amp`` under the reference's
op name ("linear", on the white list; "embedding"; "clone" for dropout's
identity). Dropout runs only where it is the identity, and returns
``x.clone()`` there as the reference does (the clone is no copy here:
nothing writes to it in place); a positive rate in training raises
(ROADMAP Queue A, "BERT training"), and so do ``axis`` and
``mode="downscale_in_infer"`` (ROADMAP Queue A, "Transformer family and
``nn`` options").
"""
from __future__ import annotations

import torch

from ...amp import cast
from ...tensor import clone

__all__ = ["linear", "embedding", "dropout", "check_dropout_options",
           "TRAINING_ITEM", "OPTIONS_ITEM"]

TRAINING_ITEM = "ROADMAP Queue A, 'BERT training'"
OPTIONS_ITEM = "ROADMAP Queue A, 'Transformer family and nn options'"


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``x @ weight + bias`` with ``weight`` as ``[in, out]``."""
    if bias is None:
        x, weight = cast("linear", x, weight)
        return torch.matmul(x, weight)
    x, weight, bias = cast("linear", x, weight, bias)
    return torch.matmul(x, weight) + bias


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows ``x`` of ``weight`` (``padding_idx`` and ``sparse`` are not
    ported: ``nn.Embedding`` refuses them), in the dtype amp gives the
    table. The rows are gathered from the table as it is and then cast,
    the same values as rows of the cast table, so the backward sums each
    row's gradients in the table's dtype (fp32 for amp's masters) on
    every device, where a gather from a bf16 copy would sum them in bf16
    (on the CPU, rounding after each of the 4096 additions a BERT token
    type takes at 16 x 512). Through PyTorch's embedding, whose backward
    sums by sorting the ids: an indexing backward (``weight[x]``) adds
    with atomics, which serialise on two rows at BERT's two token types
    (5.1 ms a step at 16 x 512 on an NVIDIA H100 80GB HBM3 at 700 W,
    ``chip_smoke.py`` phase 25's profile)."""
    ids, cast_weight = cast("embedding", x, weight)
    rows = torch.nn.functional.embedding(ids, weight)
    return rows if cast_weight.dtype == weight.dtype else rows.to(
        cast_weight.dtype)


def check_dropout_options(axis, mode) -> None:
    """Only whole-tensor ``upscale_in_train`` dropout is ported."""
    if axis is not None or mode != "upscale_in_train":
        raise NotImplementedError(f"dropout axis={axis!r}, mode={mode!r} is "
                                  f"not ported yet ({OPTIONS_ITEM})")


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training=True,
            mode: str = "upscale_in_train") -> torch.Tensor:
    """The identity (``clone``) at inference or at rate 0; raises for a
    positive rate in training, which is not ported yet."""
    check_dropout_options(axis, mode)
    if p and training:
        raise NotImplementedError(f"dropout > 0 in training is not ported "
                                  f"yet ({TRAINING_ITEM})")
    return clone(x)
