"""Fused functionals of the port (reference:
``paddle_tpu/incubate/nn/__init__.py``): ``functional``. The reference's
fused layers are not ported yet (ROADMAP Queue A, "incubate
functionals")."""
from . import functional

__all__ = ["functional"]
