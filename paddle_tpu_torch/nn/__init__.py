"""Neural-network layers and functionals of the port (reference:
``paddle_tpu/nn``): what BERT inference needs."""
from . import functional
from .layer import (Dropout, Embedding, LayerNorm, Linear,
                    MultiHeadAttention, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "functional"]
