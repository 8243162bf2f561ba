"""paddle_tpu_torch.robustness (reference: ``paddle_tpu/robustness``).

Ported: the watchdog (``NanGuard``, ``HangDetector``, the circuit
breaker) and the replica-integrity guard (``params_digest``,
``ReplicaGuard``) that the serving ``ReplicaSet`` runs. The rest
(checkpointing, fault injection, preemption, collective timeouts,
resumable loaders, elastic resume) is ROADMAP Queue A 14.
"""
from .distributed_ft import (  # noqa: F401
    INTEGRITY_POLICIES, ReplicaDivergenceError, ReplicaGuard, params_digest,
)
from .watchdog import (  # noqa: F401
    POLICIES, CircuitBreakerTripped, HangDetector, NanGuard, NanLossError,
)

__all__ = ["NanGuard", "HangDetector", "NanLossError",
           "CircuitBreakerTripped", "POLICIES", "ReplicaDivergenceError",
           "ReplicaGuard", "INTEGRITY_POLICIES", "params_digest"]
