"""The checkpoint and integrity errors (reference:
``paddle_tpu/framework/errors.py``, ``NotFoundError``,
``UnavailableError``, ``FatalError``, ``CheckpointNotFoundError``,
``CheckpointCorruptError``, ``ReplicaDivergenceError``): the port's own
copy of the classes that ``framework/io.py`` and
``robustness/distributed_ft.py`` raise, subclassing the same Python
exceptions, so ``except FileNotFoundError`` and ``except KeyError`` code
keeps working."""
from __future__ import annotations

__all__ = ["NotFoundError", "UnavailableError", "FatalError",
           "CheckpointNotFoundError", "CheckpointCorruptError",
           "ReplicaDivergenceError"]


class NotFoundError(KeyError):
    """errors.h NotFound"""


class UnavailableError(RuntimeError):
    """errors.h Unavailable"""


class FatalError(SystemError):
    """errors.h Fatal"""


class CheckpointNotFoundError(NotFoundError, FileNotFoundError):
    """``paddle.load`` target does not exist. Also a FileNotFoundError so
    ``except FileNotFoundError`` callers keep working."""


class CheckpointCorruptError(UnavailableError):
    """Checkpoint exists but fails deserialization (torn write from a
    crash mid-save, truncation, bit rot)."""


class ReplicaDivergenceError(FatalError):
    """Cross-replica integrity check failed: the replicas' parameter
    digests disagree (silent data corruption or desync). Carries the
    digests so a postmortem can name the minority replica."""

    def __init__(self, message="", *, step=None, local=None, agreed_min=None,
                 agreed_max=None):
        super().__init__(message)
        self.step = step
        self.local = local
        self.agreed_min = agreed_min
        self.agreed_max = agreed_max
