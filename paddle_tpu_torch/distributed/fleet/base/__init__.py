from .distributed_strategy import DistributedStrategy  # noqa: F401
