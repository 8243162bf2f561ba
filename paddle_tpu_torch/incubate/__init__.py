"""Experimental features of the port (reference:
``paddle_tpu/incubate/__init__.py``): the fused functionals of
``incubate.nn``."""
from . import nn

__all__ = ["nn"]
