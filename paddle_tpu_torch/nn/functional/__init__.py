"""Functionals of the port (reference: ``paddle_tpu/nn/functional``)."""
from .activation import gelu, relu
from .attention import scaled_dot_product_attention
from .common import dropout, linear
from .norm import layer_norm

__all__ = ["dropout", "gelu", "layer_norm", "linear", "relu",
           "scaled_dot_product_attention"]
