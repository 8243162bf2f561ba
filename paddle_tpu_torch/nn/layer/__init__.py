"""Layers of the port (reference: ``paddle_tpu/nn/layer``)."""
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
