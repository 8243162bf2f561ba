"""Int8 weight-only serving conversion (reference:
``paddle_tpu/quantization/__init__.py`` ``quant_abs_max``, ``Int8Linear``
and ``convert_to_int8``).

``convert_to_int8(model)`` swaps every port ``nn.Linear`` for an
``Int8Linear``: the weight is quantized once, per output column, through
``ops.quant_matmul.quantize_int8`` under a seed derived from the weight's
reference name (``stable_seed``), and every later call multiplies through
``quant_matmul``. On the card those are the hand-written kernels of
``csrc/quant_matmul.cu``.

Under ``amp`` the layer is no cast point, as in the reference (its
forward dispatches no op): ``x`` arrives in whatever dtype the op before
it gave (at ``bert-test`` under O2, 9 of the 15 layers get bf16 and the 6
fed by a ``layer_norm`` fp32), the product comes out in ``x``'s dtype
(``quant_matmul``'s bf16 form for bf16 ``x``), and the fp32 bias is
added by plain promotion, so the layer returns fp32 either way
(``paddle_tpu/quantization/__init__.py:136-149``).

Not ported yet (ROADMAP Queue A, "QAT/PTQ"): ``fake_quant_dequant``,
``FakeQuantAbsMax``, ``QuantedLinear``/``QuantedConv2D``,
``ImperativeQuantAware``, ``PostTrainingQuantization`` and
``quantization/observers.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layer.common import Linear
from ..ops.quant_matmul import quant_matmul, quantize_int8, stable_seed

__all__ = ["quant_abs_max", "Int8Linear", "convert_to_int8"]


def quant_abs_max(x, bits: int = 8) -> float:
    """Symmetric abs-max scale of a whole tensor."""
    return float(torch.as_tensor(x).abs().max()) / (2 ** (bits - 1) - 1)


class Int8Linear(nn.Module):
    """Weight-only int8 serving ``Linear``: ``qweight`` int8 ``[in, out]``
    and ``scales`` fp32 ``[1, out]`` as buffers, the float bias kept.
    Inference only: the forward runs without autograd."""

    def __init__(self, layer: Linear, stochastic: bool = False, seed=None):
        super().__init__()
        self.weight_name = layer.weight_name
        if seed is None:
            seed = stable_seed(self.weight_name)
        weight = layer._parameters["weight"]
        q, s = quantize_int8(weight.detach().to(torch.float32)
                             .contiguous(), stochastic=stochastic, seed=seed)
        self.register_buffer("qweight", q)
        self.register_buffer("scales", s)
        self.bias = layer._parameters.get("bias")
        self.out_features = int(weight.shape[1])

    def forward(self, x):
        with torch.no_grad():
            k = x.shape[-1]
            out = quant_matmul(x.reshape(-1, k).contiguous(), self.qweight,
                               self.scales, out_dtype=x.dtype)
            out = out.reshape(*x.shape[:-1], self.out_features)
            return out if self.bias is None else out + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.qweight.shape[0]}, "
                f"out_features={self.out_features}, int8")


def convert_to_int8(model: nn.Module, stochastic: bool = False) -> nn.Module:
    """Replace every ``Linear`` child of ``model`` and of its submodules
    with an ``Int8Linear`` (in place; returns ``model``). Each layer
    quantizes under its own name-derived seed."""
    for _, parent in list(model.named_modules()):
        for name, child in list(parent.named_children()):
            if type(child) is Linear:
                setattr(parent, name, Int8Linear(child,
                                                 stochastic=stochastic))
    return model
