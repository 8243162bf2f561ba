"""Distributed pieces of the port (reference: ``paddle_tpu/distributed``)."""
