"""Functionals of the port (reference: ``paddle_tpu/nn/functional``)."""
from .activation import gelu, relu, sigmoid, tanh
from .attention import flash_route, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cross_entropy)
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "conv1d",
           "conv1d_transpose", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "cross_entropy", "dropout", "embedding",
           "flash_route", "gelu", "layer_norm", "linear", "max_pool2d",
           "relu", "scaled_dot_product_attention", "sigmoid", "tanh"]
