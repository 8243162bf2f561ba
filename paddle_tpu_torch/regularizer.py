"""``paddle.regularizer`` (reference: ``paddle_tpu/regularizer.py``):
L1/L2 weight decay as a coefficient that the optimizer's update applies
(``Optimizer._param_wd`` reads ``_coeff``; a parameter's own
``regularizer``, from its ``ParamAttr``, overrides the optimizer's)."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self.coeff = self._coeff

    def __repr__(self):
        return f"L2Decay(coeff={self._coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self.coeff = self._coeff
        self._l1 = True

    def __repr__(self):
        return f"L1Decay(coeff={self._coeff})"
