"""``paddle.distributed.fleet`` (reference:
``paddle_tpu/distributed/fleet/__init__.py``): only
``DistributedStrategy`` so far. ``fleet.init``, ``distributed_model``,
``distributed_optimizer`` and the rest are ROADMAP Queue A item 10
(parallelism)."""
from .base.distributed_strategy import DistributedStrategy  # noqa: F401

__all__ = ["DistributedStrategy"]
