"""Functionals of the port (reference: ``paddle_tpu/nn/functional``)."""
from .activation import gelu, relu, tanh
from .attention import flash_route, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["cross_entropy", "dropout", "embedding", "flash_route", "gelu",
           "layer_norm", "linear", "relu", "scaled_dot_product_attention",
           "tanh"]
