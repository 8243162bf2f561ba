"""Observability of the port (reference: ``paddle_tpu/observability``)."""
