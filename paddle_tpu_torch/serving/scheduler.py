"""Request queue and admission control (reference:
``paddle_tpu/serving/scheduler.py``).

A bounded FIFO feeds the engine. Admission happens at ``submit``: a full
queue rejects at once (open-loop traffic gets backpressure at the door),
counted as ``serve_requests_total{outcome="rejected"}``. A request put
back for lack of KV room goes to the FRONT of the queue without a new
depth check. Host code: nothing here touches the device. Request tracing
spans stay in the reference until a later slice.
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
from .sampler import GREEDY, SamplingParams

__all__ = ["ServeRequest", "RequestQueue", "OUTCOMES", "count_outcome"]

OUTCOMES = ("completed", "rejected", "failed")

_req_counter = itertools.count()

_m_requests = _get_registry().counter(
    "serve_requests_total",
    "serving requests by terminal outcome", labels=("outcome",))
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
    # the request_id names the random stream unless sampling.seed pins one
    sampling: SamplingParams = GREEDY
    # -- bookkeeping (owned by the runtime) --
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    generated: List[int] = field(default_factory=list)
    outcome: str = ""
    error: str = ""

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


class RequestQueue:
    """Bounded thread-safe FIFO with front re-admission (requests may be
    submitted from any thread while the engine steps)."""

    def __init__(self, max_depth: Optional[int] = None):
        self.max_depth = int(max_depth
                             or flag("FLAGS_serving_queue_depth"))
        self._q: deque = deque()
        self._lock = threading.Lock()

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, req: ServeRequest) -> bool:
        """False (and a ``rejected`` count) when the queue is at depth;
        True once the request is accepted."""
        with self._lock:
            if len(self._q) >= self.max_depth:
                count_outcome("rejected")
                return False
            if not req.t_submit:
                req.t_submit = time.monotonic()
            self._q.append(req)
            _m_queue_depth.set(len(self._q))
        return True

    def requeue_front(self, reqs: List[ServeRequest]):
        """Put admitted requests back at the head (no depth check): the
        scheduler's put-back when the pool has no KV room this tick."""
        with self._lock:
            self._q.extendleft(reversed(reqs))
            _m_queue_depth.set(len(self._q))

    def pop_nowait(self) -> Optional[ServeRequest]:
        with self._lock:
            if not self._q:
                return None
            r = self._q.popleft()
            _m_queue_depth.set(len(self._q))
            return r
