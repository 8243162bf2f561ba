"""Neural-network layers and functionals of the port (reference:
``paddle_tpu/nn``): the layers, losses, containers, norms, pools and
functionals of the feed-forward surface, ``Layer``, the initializers,
``ParamAttr``/``Parameter`` and the gradient clips. Not ported yet: the
RNN family, ``decode``, ``utils`` and ``HSigmoidLoss`` (ROADMAP Queue A
4c-2), the Transformer decoder family (Queue A 11) and the transposed
convolution layers (Queue A 14)."""
from . import functional, initializer, layer
from ..framework.param_attr import ParamAttr
from ..framework.tensor import Parameter
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403

__all__ = sorted({*layer.__all__, "ClipGradByGlobalNorm", "ClipGradByNorm",
                  "ClipGradByValue", "ParamAttr", "Parameter",
                  "functional", "initializer"})
