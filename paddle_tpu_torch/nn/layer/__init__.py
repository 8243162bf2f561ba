"""Layers of the port (reference: ``paddle_tpu/nn/layer``)."""
from .activation import ReLU, Sigmoid
from .common import Dropout, Embedding, Flatten, Linear
from .container import Sequential
from .loss import BCELoss, BCEWithLogitsLoss
from .conv import Conv1D, Conv2D, Conv3D
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BCELoss", "BCEWithLogitsLoss",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "Conv1D", "Conv2D", "Conv3D", "Dropout", "Embedding", "Flatten",
           "LayerNorm", "Linear", "MaxPool2D", "MultiHeadAttention", "ReLU",
           "Sequential", "Sigmoid", "TransformerEncoder",
           "TransformerEncoderLayer"]
