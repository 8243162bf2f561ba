"""Watchdog: NaN/Inf guard, circuit breaker and hang detector
(reference: ``paddle_tpu/robustness/watchdog.py``; host code).

- ``NanGuard.check(loss, grads)``: a finiteness check a step with the
  policy ``skip_step`` (drop the update), ``rollback`` (restore the last
  checkpoint) or ``raise``, and a consecutive-bad-step circuit breaker
  that overrides any policy. A step the loss scaler already skipped
  (``scaler_skipped=True``) neither acts nor advances the breaker. A
  tensor on the card is checked there; one bool comes back.
- ``HangDetector``: heartbeat stall detection. The loop ``beat()``s, a
  daemon thread calls ``on_hang(age)`` once a stall when the last beat
  is older than the timeout (``max(timeout, compile_grace)`` while
  ``state_fn()`` reports "compiling"); ``escalate()`` reports a stall at
  once. Both count, log an event and dump the flight recorder. It
  reports; it cannot interrupt a thread stuck in a call.
"""
from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from ..observability import get_event_log
from ..observability.flight_recorder import dump_flight_recorder
from ..observability.metrics import get_registry as _get_registry

__all__ = ["NanGuard", "HangDetector", "NanLossError",
           "CircuitBreakerTripped", "POLICIES"]

_LOG = logging.getLogger(__name__)

# trip and heartbeat counts go to the registry; each trip or stall also
# lands in the event log with its context
_m_guard_steps = _get_registry().counter(
    "nan_guard_steps_total", help="steps classified by NanGuard").bind()
_m_guard_trips = _get_registry().counter(
    "nan_guard_trips_total",
    help="non-finite steps caught by NanGuard", labels=("action",))
_m_scaler_skips = _get_registry().counter(
    "nan_guard_scaler_skipped_total",
    help="steps exempted because the AMP scaler already skipped").bind()
_m_heartbeats = _get_registry().counter(
    "watchdog_heartbeats_total", help="HangDetector beats").bind()
_m_hangs = _get_registry().counter(
    "watchdog_hangs_total", help="stalls detected by HangDetector").bind()

POLICIES = ("skip_step", "rollback", "raise")


class NanLossError(FloatingPointError):
    """Non-finite loss/gradient under policy='raise'."""


class CircuitBreakerTripped(RuntimeError):
    """Too many consecutive non-finite steps — the run is diverging."""


def _is_finite(x):
    if x is None:
        return True
    x = getattr(x, "_value", x)          # an eager Tensor's torch.Tensor
    if isinstance(x, torch.Tensor):
        if not (x.is_floating_point() or x.is_complex()):
            return True
        return bool(torch.isfinite(x).all())
    if hasattr(x, "numpy"):
        x = x.numpy()
    arr = np.asarray(x)
    if arr.dtype.kind not in "fc":
        return True
    return bool(np.isfinite(arr).all())


class NanGuard:
    def __init__(self, policy="skip_step", max_consecutive_bad=8):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        self.policy = policy
        self.max_consecutive_bad = max_consecutive_bad
        self.reset()

    def reset(self):
        self.consecutive_bad = 0
        self.total_bad = 0
        self.total_steps = 0

    def state_dict(self) -> dict:
        """Breaker counters for the checkpoint job_state entry: a resumed
        run that was 7/8 steps into a divergence must not get a fresh
        breaker budget."""
        return {"consecutive_bad": self.consecutive_bad,
                "total_bad": self.total_bad,
                "total_steps": self.total_steps}

    def load_state_dict(self, state: dict):
        self.consecutive_bad = int(state["consecutive_bad"])
        self.total_bad = int(state["total_bad"])
        self.total_steps = int(state["total_steps"])

    def check(self, loss=None, grads=None, scaler_skipped=False):
        """Classify one step. Returns "ok" or the policy action
        ("skip_step"/"rollback"); raises NanLossError under policy='raise'
        and CircuitBreakerTripped when the breaker limit is hit."""
        self.total_steps += 1
        _m_guard_steps.value += 1
        if scaler_skipped:
            # the loss scaler found the overflow, skipped the update, and
            # will shrink its scale — routine fp16 dynamics, not divergence;
            # must not advance the breaker
            _m_scaler_skips.value += 1
            return "ok"
        bad = not _is_finite(loss) or any(
            not _is_finite(g) for g in (grads or []))
        if not bad:
            self.consecutive_bad = 0
            return "ok"
        self.consecutive_bad += 1
        self.total_bad += 1
        if self.max_consecutive_bad and \
                self.consecutive_bad >= self.max_consecutive_bad:
            _m_guard_trips.labels(action="breaker").inc()
            get_event_log().error(
                "nan_guard", "circuit breaker tripped",
                step=self.total_steps, consecutive=self.consecutive_bad,
                policy=self.policy)
            dump_flight_recorder("nan_guard:breaker")
            raise CircuitBreakerTripped(
                f"{self.consecutive_bad} consecutive non-finite steps "
                f"(policy {self.policy!r} could not recover) — aborting")
        _m_guard_trips.labels(action=self.policy).inc()
        get_event_log().warning(
            "nan_guard", "non-finite loss/gradient", step=self.total_steps,
            action=self.policy, consecutive=self.consecutive_bad)
        # postmortem while the evidence is fresh: the ring's tail is the
        # exact op/comm sequence that produced the non-finite step
        dump_flight_recorder(f"nan_guard:{self.policy}")
        if self.policy == "raise":
            raise NanLossError(
                f"non-finite loss/gradient at step {self.total_steps}")
        _LOG.warning("non-finite loss/gradient at step %d -> %s "
                     "(%d consecutive)", self.total_steps, self.policy,
                     self.consecutive_bad)
        return self.policy

    def check_gradients(self, parameters, scaler_skipped=False):
        grads = [p.grad for p in parameters if getattr(p, "grad", None)
                 is not None]
        return self.check(grads=grads, scaler_skipped=scaler_skipped)


class HangDetector:
    """Heartbeat-based stall detection.

        hd = HangDetector(timeout=120, on_hang=alert)
        hd.start()
        for batch in loader:
            train_step(batch)
            hd.beat()
        hd.stop()

    When no beat arrives for `timeout` seconds the daemon thread marks the
    run stalled, bumps `hang_count`, and calls `on_hang(stall_age)` once per
    stall (re-armed by the next beat). It observes and reports — it cannot
    interrupt a thread stuck inside a collective; pair it with an external
    supervisor (elastic relaunch) for the kill.
    """

    def __init__(self, timeout=60.0, poll_interval=None, on_hang=None,
                 state_fn=None, compile_grace=None):
        self.timeout = float(timeout)
        self.poll_interval = poll_interval if poll_interval is not None \
            else max(min(self.timeout / 4.0, 1.0), 0.01)
        self.on_hang = on_hang
        # compile-aware grace: while `state_fn()` reports "compiling" the
        # deadline stretches to max(timeout, compile_grace). A cold first
        # call (a kernel library's build, cuBLAS's setup, the allocator's
        # growth) looks like a hang to a heartbeat detector; this scopes
        # the allowance to the window the loop says it is compiling.
        self.state_fn = state_fn
        self.compile_grace = float(compile_grace) if compile_grace else 0.0
        self.stalled = False
        self.hang_count = 0
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = None

    def effective_timeout(self) -> float:
        if self.state_fn is not None and self.compile_grace:
            try:
                state = self.state_fn()
            except Exception:
                state = None
            if state == "compiling":
                return max(self.timeout, self.compile_grace)
        return self.timeout

    def beat(self):
        self._last = time.monotonic()
        self.stalled = False
        _m_heartbeats.value += 1

    def escalate(self, reason="external stall report"):
        """External stall escalation (e.g. a collective that exhausted its
        retries): counts as a hang and fires `on_hang` at once instead of
        waiting for the heartbeat to go stale. Re-armed by the next beat
        like a detected stall."""
        self.stalled = True
        self.hang_count += 1
        _m_hangs.value += 1
        age = time.monotonic() - self._last
        get_event_log().error("watchdog", f"stall escalated: {reason}",
                              stall_age_seconds=round(age, 3))
        dump_flight_recorder(f"hang_escalated:{reason}"[:120])
        if self.on_hang is not None:
            try:
                self.on_hang(age)
            except Exception:
                _LOG.exception("on_hang callback failed")

    def start(self):
        self.beat()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hang-detector")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self):
        while not self._stop.wait(self.poll_interval):
            age = time.monotonic() - self._last
            deadline = self.effective_timeout()
            if age > deadline and not self.stalled:
                self.stalled = True
                self.hang_count += 1
                _m_hangs.value += 1
                get_event_log().error(
                    "watchdog", "training stalled: heartbeat stale",
                    stall_age_seconds=round(age, 3),
                    timeout_seconds=deadline)
                dump_flight_recorder("hang:heartbeat_stale")
                if self.on_hang is not None:
                    try:
                        self.on_hang(age)
                    except Exception:
                        _LOG.exception("on_hang callback failed")
                else:
                    _LOG.warning("training stalled: no heartbeat for %.1fs "
                                 "(timeout %.1fs)", age, self.timeout)
