"""Replica-integrity guard (reference:
``paddle_tpu/robustness/distributed_ft.py:263-420``: ``params_digest``,
``INTEGRITY_POLICIES``, ``ReplicaGuard``; ``ReplicaDivergenceError``
from its ``framework/errors.py``).

A bit flip or a desynced replica corrupts every later step.
``ReplicaGuard`` runs a cheap agreement check: a crc32 digest of the
parameters (``params_digest``, the reference's digest on the same
values), reduced with MIN and MAX over the group through the port's
``collective.all_reduce``; disagreement triggers the policy ``raise``,
``rebroadcast_from_src`` or ``rollback``. The serving ``ReplicaSet``
runs it with policy "raise" against the set's boot-time digest.

Not ported (ROADMAP Queue A 14): the rest of the module (collective
timeouts and retries, chaos interposers, ``ResumableLoader``, job state
capture and restore, ``elastic_resume``, ``agree_bucket_assignment``).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ..framework.errors import ReplicaDivergenceError
from ..observability import get_event_log
from ..observability.flight_recorder import dump_flight_recorder
from ..observability.metrics import get_registry as _get_registry

__all__ = ["params_digest", "INTEGRITY_POLICIES", "ReplicaGuard",
           "ReplicaDivergenceError"]

_m_integrity = _get_registry().counter(
    "integrity_checks_total",
    help="cross-replica parameter agreement checks", labels=("result",))

INTEGRITY_POLICIES = ("raise", "rebroadcast_from_src", "rollback")


def _raw_bytes(p) -> bytes:
    """A parameter's bytes in row-major order: a tensor on the card is
    copied to the host, a bf16 or fp16 tensor read as its 16-bit words
    (numpy has no bfloat16), so the bytes are the reference's for the
    same values."""
    val = getattr(p, "_value", p)        # an eager Tensor's torch.Tensor
    if isinstance(val, torch.Tensor):
        t = val.detach().contiguous().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(val)).tobytes()


def params_digest(params) -> np.ndarray:
    """Cheap deterministic fingerprint of a parameter set: a chained crc32
    over every parameter's raw bytes, in order, split into two int32
    halves (a collective carries int32 exactly). Identical across
    replicas iff every byte is."""
    crc = 0
    for p in params:
        crc = zlib.crc32(_raw_bytes(p), crc)
    return np.array([crc >> 16, crc & 0xFFFF], dtype=np.int32)


def _reduce_min_max(digest, group):
    """Default cross-replica agreement reduce: MIN and MAX of the digest
    over the group's ranks, through the port's ``collective.all_reduce``
    (one process, no group: the digest itself, twice)."""
    from ..distributed import collective as coll

    tmin = torch.from_numpy(np.array(digest, dtype=np.int32))
    tmax = tmin.clone()
    coll.all_reduce(tmin, op=coll.ReduceOp.MIN, group=group)
    coll.all_reduce(tmax, op=coll.ReduceOp.MAX, group=group)
    return tmin.numpy().copy(), tmax.numpy().copy()


class ReplicaGuard:
    """Periodic cross-replica parameter agreement check.

        guard = ReplicaGuard(policy="rollback", every_n=20,
                             checkpoint=robust_ckpt_callback)
        for step, batch in enumerate(loader):
            train_step(batch)
            guard.maybe_check(model.parameters(), step=step)

    Detection: each replica digests its parameters (crc32 -> int32 pair) and
    the group reduces the digest with MIN and MAX; MIN != MAX means at least
    one replica disagrees (SDC or desync), caught within `every_n` steps
    instead of never. A check copies the parameters to the host and hashes
    them, then runs two 2-element collectives.

    Policies on divergence:
    - ``raise``: fail fast with ReplicaDivergenceError (digests attached).
    - ``rebroadcast_from_src``: re-replicate parameters from `src_rank`
      (via `rebroadcast_fn(params)` when given — the eager/emulated path —
      else collective.broadcast per parameter), then re-verify.
    - ``rollback``: restore the last valid checkpoint through `checkpoint`
      (any object with a ``rollback() -> bool`` — e.g.
      hapi.callbacks.RobustCheckpoint), then re-verify.
    A policy that fails to restore agreement escalates to ``raise``.

    `reduce_fn(digest) -> (min, max)` overrides the group reduce: the
    serving ``ReplicaSet`` holds each replica's digest against the
    boot-time one with it.
    """

    def __init__(self, policy="raise", every_n=1, group=None, checkpoint=None,
                 src_rank=0, reduce_fn=None, rebroadcast_fn=None):
        if policy not in INTEGRITY_POLICIES:
            raise ValueError(
                f"policy must be one of {INTEGRITY_POLICIES}, got {policy!r}")
        if policy == "rollback" and checkpoint is None:
            raise ValueError("policy='rollback' needs a checkpoint target "
                             "(an object with .rollback())")
        self.policy = policy
        self.every_n = max(1, int(every_n))
        self.group = group
        self.checkpoint = checkpoint
        self.src_rank = int(src_rank)
        self.reduce_fn = reduce_fn
        self.rebroadcast_fn = rebroadcast_fn
        self.checks = 0
        self.divergences = 0
        self._step = 0

    # ------------------------------------------------------------ checking
    def maybe_check(self, params, step=None):
        """check() on every `every_n`-th call; "skipped" otherwise."""
        self._step += 1
        if self._step % self.every_n:
            return "skipped"
        return self.check(params, step=step)

    def _agree(self, params):
        digest = params_digest(params)
        if self.reduce_fn is not None:
            dmin, dmax = self.reduce_fn(digest)
        else:
            dmin, dmax = _reduce_min_max(digest, self.group)
        return digest, np.asarray(dmin), np.asarray(dmax)

    def check(self, params, step=None):
        """Run one agreement check. Returns "ok" or the recovery action
        taken; raises ReplicaDivergenceError under policy='raise' or when
        recovery fails to restore agreement."""
        params = list(params)
        self.checks += 1
        digest, dmin, dmax = self._agree(params)
        if np.array_equal(dmin, dmax):
            _m_integrity.labels(result="ok").inc()
            return "ok"
        self.divergences += 1
        _m_integrity.labels(result="diverged").inc()
        get_event_log().error(
            "integrity", "replica divergence detected",
            step=step, policy=self.policy, local=digest.tolist(),
            agreed_min=dmin.tolist(), agreed_max=dmax.tolist())
        # SDC postmortem: the ring's tail shows what ran between the last
        # agreeing check and this one
        dump_flight_recorder(f"replica_divergence:step{step}")
        if self.policy == "raise":
            raise self._error(step, digest, dmin, dmax)
        if self.policy == "rebroadcast_from_src":
            self._rebroadcast(params)
        else:  # rollback
            if not self.checkpoint.rollback():
                raise self._error(
                    step, digest, dmin, dmax,
                    note="rollback found no valid checkpoint")
        # recovery must actually restore agreement: re-verify, fail loud
        digest, dmin, dmax = self._agree(params)
        if not np.array_equal(dmin, dmax):
            raise self._error(step, digest, dmin, dmax,
                              note=f"{self.policy} did not restore agreement")
        _m_integrity.labels(result=self.policy).inc()
        get_event_log().warning(
            "integrity", f"replicas re-agreed after {self.policy}", step=step)
        return self.policy

    def _rebroadcast(self, params):
        if self.rebroadcast_fn is not None:
            self.rebroadcast_fn(params)
            return
        from ..distributed import collective as coll

        for p in params:
            coll.broadcast(p, src=self.src_rank, group=self.group)

    @staticmethod
    def _error(step, digest, dmin, dmax, note=None):
        msg = (f"replica parameter digests disagree (min {dmin.tolist()} != "
               f"max {dmax.tolist()}, local {digest.tolist()})"
               + (f" at step {step}" if step is not None else "")
               + (f": {note}" if note else "")
               + ": silent data corruption or desync")
        return ReplicaDivergenceError(msg, step=step, local=digest,
                                      agreed_min=dmin, agreed_max=dmax)
