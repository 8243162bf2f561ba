"""Kernel wrappers of the port (reference: ``paddle_tpu/ops``)."""
