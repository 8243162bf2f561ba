"""Layers of the port (reference: ``paddle_tpu/nn/layer``)."""
from . import activation, common, container, loss, norm, pooling, rnn
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import Conv1D, Conv2D, Conv3D
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = sorted({"Conv1D", "Conv2D", "Conv3D", "Layer",
                  "MultiHeadAttention", "TransformerEncoder",
                  "TransformerEncoderLayer",
                  *activation.__all__, *common.__all__, *container.__all__,
                  *loss.__all__, *norm.__all__, *pooling.__all__,
                  *rnn.__all__})
