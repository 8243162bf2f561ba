"""ParamAttr (reference: ``paddle_tpu/framework/param_attr.py``).

What a ``Layer.create_parameter`` call takes beside the shape: the
parameter's ``name``, its ``initializer``, its ``learning_rate``
multiplier (carried as ``p.optimize_attr["learning_rate"]``), its
``regularizer`` (``p.regularizer``, whose ``_coeff`` replaces the
optimizer's weight decay for it), ``trainable`` and ``need_clip``
(False keeps its gradient out of ``grad_clip``). ``_to_attr`` reads the
forms the reference's layers take: None, a ``ParamAttr``, a name, an
initializer, or False (no parameter).
"""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr(initializer=attr)
