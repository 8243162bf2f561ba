"""Request queue and admission control (reference:
``paddle_tpu/serving/scheduler.py``).

One bounded FIFO feeds every replica. Admission happens at ``submit``: a
full (or closed) queue rejects at once (open-loop traffic gets
backpressure at the door), counted as
``serve_requests_total{outcome="rejected"}``. ``submit`` stamps the
enqueue time and mints the request's trace (``observability/tracing``),
which the request carries across evictions. A replica eviction puts the
drained requests back at the FRONT of the queue without a depth check
(they were already accepted: zero lost), counted as "requeued" with a
``requeue_front`` span; the scheduler's put-back for lack of KV room
(``count=False``) is flow control and counts nothing. Host code: nothing
here touches the device.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..framework.flags import flag
from ..observability.metrics import get_registry as _get_registry
from ..observability.tracing import get_tracer as _get_tracer
from .sampler import GREEDY, SamplingParams

__all__ = ["ServeRequest", "RequestQueue", "OUTCOMES", "count_outcome"]

OUTCOMES = ("completed", "rejected", "requeued", "failed")

_req_counter = itertools.count()

_m_requests = _get_registry().counter(
    "serve_requests_total",
    "serving requests by terminal/requeue outcome", labels=("outcome",))
_m_queue_depth = _get_registry().gauge(
    "serve_queue_depth", "requests waiting for admission to a decode batch")


def count_outcome(outcome: str, n: int = 1):
    if outcome not in OUTCOMES:
        raise ValueError(f"outcome must be one of {OUTCOMES}, got {outcome!r}")
    _m_requests.labels(outcome=outcome).inc(n)


@dataclass
class ServeRequest:
    """One generation request plus its serving bookkeeping."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    request_id: str = field(
        default_factory=lambda: f"req-{next(_req_counter)}")
    # the request_id names the random stream unless sampling.seed pins
    # one, so tokens do not depend on batch placement, replica or replay
    sampling: SamplingParams = GREEDY
    # -- bookkeeping (owned by the runtime) --
    t_submit: float = 0.0
    t_enqueue: float = 0.0  # last time this attempt entered the queue
    t_first_token: float = 0.0
    t_done: float = 0.0
    generated: List[int] = field(default_factory=list)
    outcome: str = ""
    attempts: int = 0
    error: str = ""
    # request-scoped trace: minted at submit, carried across eviction and
    # reincarnation, so one request is one timeline
    trace: Optional[object] = None

    @property
    def n_prompt(self) -> int:
        return len(self.prompt_ids)

    @property
    def context_budget(self) -> int:
        """Max tokens this request can ever hold in the KV cache: the
        prompt plus every token it may generate except the last (whose KV
        is never appended)."""
        return self.n_prompt + max(0, self.max_new_tokens - 1)

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_submit) * 1e3 if self.t_done else 0.0

    @property
    def ttft_ms(self) -> float:
        return ((self.t_first_token - self.t_submit) * 1e3
                if self.t_first_token else 0.0)

    def reincarnate(self) -> "ServeRequest":
        """A fresh attempt of a drained request: the same identity, submit
        time (latency counts from the first arrival) and trace, attempts
        + 1, clean generation state. A new object, so the evicted
        replica's zombie thread, which may still hold the old one inside
        a hung step, cannot race the re-run."""
        return ServeRequest(
            prompt_ids=self.prompt_ids, max_new_tokens=self.max_new_tokens,
            eos_id=self.eos_id, request_id=self.request_id,
            sampling=self.sampling,
            t_submit=self.t_submit, attempts=self.attempts + 1,
            trace=self.trace)


class RequestQueue:
    """Bounded thread-safe FIFO with front re-admission (requests may be
    submitted from any thread while the replicas step)."""

    def __init__(self, max_depth: Optional[int] = None):
        self.max_depth = int(max_depth
                             or flag("FLAGS_serving_queue_depth"))
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self):
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, req: ServeRequest) -> bool:
        """False (and a ``rejected`` count) when the queue is at depth or
        closed; True once the request is accepted."""
        with self._cond:
            if self._closed or len(self._q) >= self.max_depth:
                count_outcome("rejected")
                return False
            if not req.t_submit:
                req.t_submit = time.monotonic()
            req.t_enqueue = time.monotonic()
            if req.trace is None:
                req.trace = _get_tracer().start_trace(
                    "serve_request", request_id=req.request_id,
                    n_prompt=req.n_prompt,
                    max_new_tokens=req.max_new_tokens)
            self._q.append(req)
            _m_queue_depth.set(len(self._q))
            self._cond.notify()
        return True

    def requeue_front(self, reqs: List[ServeRequest], count: bool = True):
        """Re-admit requests at the head (no depth check). ``count=False``
        for the scheduler's put-back when the pool has no KV room this
        tick, which is flow control, not a drain."""
        with self._cond:
            now = time.monotonic()
            for r in reversed(reqs):
                r.t_enqueue = now
                self._q.appendleft(r)
            _m_queue_depth.set(len(self._q))
            if reqs:
                if count:
                    count_outcome("requeued", len(reqs))
                    tracer = _get_tracer()
                    for r in reqs:
                        tracer.record_span(r.trace, "requeue_front",
                                           attempt=r.attempts)
                self._cond.notify_all()

    def pop_nowait(self) -> Optional[ServeRequest]:
        with self._cond:
            if not self._q:
                return None
            r = self._q.popleft()
            _m_queue_depth.set(len(self._q))
            return r

    def wait_nonempty(self, timeout: float) -> bool:
        """Block until the queue has work (or timeout, or close); the
        popper still races the other replicas through ``pop_nowait``."""
        with self._cond:
            if self._q or self._closed:
                return bool(self._q)
            self._cond.wait(timeout)
            return bool(self._q)

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
