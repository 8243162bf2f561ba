"""Kernel wrappers of the port (reference: ``paddle_tpu/ops``)."""
from .quant_matmul import quant_matmul, quantize_int8, stable_seed

__all__ = ["quant_matmul", "quantize_int8", "stable_seed"]
