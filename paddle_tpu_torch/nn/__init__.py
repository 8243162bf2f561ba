"""Neural-network layers and functionals of the port (reference:
``paddle_tpu/nn``): what BERT, ResNet and Wide&Deep need, and the
gradient clips; ``Layer`` and the initializers."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (AdaptiveAvgPool2D, AvgPool2D, BCELoss,
                    BCEWithLogitsLoss, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv1D, Conv2D, Conv3D,
                    Dropout, Embedding, Flatten, Layer, LayerNorm, Linear,
                    MaxPool2D, MultiHeadAttention, ReLU, Sequential, Sigmoid,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BCELoss", "BCEWithLogitsLoss",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Conv1D", "Conv2D", "Conv3D", "Dropout", "Embedding", "Flatten",
           "Layer", "LayerNorm", "Linear", "MaxPool2D", "MultiHeadAttention", "ReLU",
           "Sequential", "Sigmoid", "TransformerEncoder",
           "TransformerEncoderLayer", "functional", "initializer"]
