"""Neural-network layers and functionals of the port (reference:
``paddle_tpu/nn``): the layers, losses, containers, norms, pools and
functionals, the recurrent layers and cells (``layer/rnn.py``), beam
search (``decode``), the sequence ops (``functional/sequence.py``), the
reparameterisations and gradient utilities (``utils``), ``Layer``, the
initializers, ``ParamAttr``/``Parameter`` and the gradient clips. Not
ported yet: the Transformer decoder family (ROADMAP Queue A 11) and the
transposed convolution layers (Queue A 14)."""
from . import decode, functional, initializer, layer, utils
from ..framework.param_attr import ParamAttr
from ..framework.tensor import Parameter
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, Decoder, dynamic_decode
from .layer import *  # noqa: F401,F403

__all__ = sorted({*layer.__all__, *decode.__all__, "ClipGradByGlobalNorm",
                  "ClipGradByNorm", "ClipGradByValue", "ParamAttr",
                  "Parameter", "decode", "functional", "initializer",
                  "utils"})
