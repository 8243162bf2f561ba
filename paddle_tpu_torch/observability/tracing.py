"""Request-scoped tracing (reference:
``paddle_tpu/observability/tracing.py``).

- ``TraceContext``: a trace id, the mint of span ids within it and a
  monotonic birth time. ``RequestQueue.submit`` mints one per
  ``ServeRequest`` and the request carries it, so ``reincarnate()``
  after an eviction keeps the same trace: one timeline per request,
  across replicas.
- ``Span``: name, span id, parent, monotonic ``[t_start, t_end)`` and a
  small JSON-safe field dict. Lifecycle edges are recorded complete
  where the edge ends (``record_span``), so a replica dying mid-step
  leaves no open span; in-function pairs use ``begin_span``/``end_span``
  or the ``span()`` context manager.
- ``TraceStore``: at most ``FLAGS_trace_store_capacity`` traces (oldest
  evicted) of at most ``FLAGS_trace_max_spans`` spans each (overflow
  counted); served at ``/traces`` and ``/traces/<id>`` while a
  ``ReplicaSet`` runs.
- Every committed span is also a flight-recorder entry (kind "trace").

Latency and TTFT histograms take ``exemplar=ctx.trace_id``, so a scraped
bucket names a trace retrievable at ``/traces/<id>``. Everything is
gated by ``FLAGS_serving_tracing``: off, no context is minted and every
helper is a no-op on ``ctx=None``. The reference's train-step traces
(its ``StepTimer``) wait for the port of ``profiler``.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Optional

__all__ = [
    "TraceContext", "Span", "TraceStore", "Tracer", "get_tracer",
    "tracing_enabled",
]

_trace_counter = itertools.count(1)


def tracing_enabled() -> bool:
    from ..framework.flags import flag

    return bool(flag("FLAGS_serving_tracing"))


class TraceContext:
    """One request's (or one train step's) identity on the timeline:
    a trace id plus the mint for span ids within it."""

    __slots__ = ("trace_id", "name", "request_id", "t_start", "_span_ids")

    def __init__(self, trace_id: str, name: str,
                 request_id: Optional[str] = None):
        self.trace_id = trace_id
        self.name = name
        self.request_id = request_id
        self.t_start = time.monotonic()
        self._span_ids = itertools.count(1)

    def next_span_id(self) -> str:
        return f"{self.trace_id}.{next(self._span_ids)}"


class Span:
    """A closed (or closing) interval on a trace's timeline. Timestamps are
    time.monotonic() so ordering survives wall-clock steps."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "t_end", "fields")

    def __init__(self, trace_id: str, span_id: str, name: str,
                 parent_id: Optional[str] = None, t_start: float = None,
                 fields: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = time.monotonic() if t_start is None else t_start
        self.t_end: Optional[float] = None
        self.fields = dict(fields or {})

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return (self.t_end - self.t_start) * 1e3

    def to_dict(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "t_start": self.t_start,
                "t_end": self.t_end, "duration_ms": self.duration_ms,
                "fields": self.fields}


class TraceStore:
    """Bounded per-request trace store: at most ``capacity`` traces
    (oldest evicted) and ``max_spans`` spans kept per trace (overflow
    counted in ``dropped_spans``, never unbounded memory)."""

    def __init__(self, capacity: int = 256, max_spans: int = 256):
        self.capacity = int(capacity)
        self.max_spans = int(max_spans)
        self.evicted_traces = 0
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._traces)

    def open(self, ctx: TraceContext, **fields) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            rec = self._traces.get(ctx.trace_id)
            if rec is None:
                rec = self._traces[ctx.trace_id] = {
                    "trace_id": ctx.trace_id, "name": ctx.name,
                    "request_id": ctx.request_id, "time": time.time(),
                    "t_start": ctx.t_start, "spans": [],
                    "dropped_spans": 0,
                }
                while len(self._traces) > self.capacity:
                    self._traces.popitem(last=False)
                    self.evicted_traces += 1
            if fields:
                rec.setdefault("fields", {}).update(fields)

    def add(self, span: Span) -> None:
        with self._lock:
            rec = self._traces.get(span.trace_id)
            if rec is None:
                return  # trace evicted (or store disabled): drop quietly
            if len(rec["spans"]) >= self.max_spans:
                rec["dropped_spans"] += 1
                return
            rec["spans"].append(span.to_dict())

    def get(self, trace_id: str) -> Optional[dict]:
        """A JSON-safe copy of one trace, spans in record order."""
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return None
            out = dict(rec)
            out["spans"] = [dict(s) for s in rec["spans"]]
            out["n_spans"] = len(out["spans"])
            return out

    def index(self) -> dict:
        """The /traces listing: per-trace summaries, newest last."""
        with self._lock:
            traces = [{"trace_id": r["trace_id"], "name": r["name"],
                       "request_id": r["request_id"],
                       "n_spans": len(r["spans"]),
                       "dropped_spans": r["dropped_spans"]}
                      for r in self._traces.values()]
        return {"capacity": self.capacity, "max_spans": self.max_spans,
                "n_traces": len(traces),
                "evicted_traces": self.evicted_traces, "traces": traces}

    def clear(self):
        with self._lock:
            self._traces.clear()
            self.evicted_traces = 0


class Tracer:
    """Span recording front-end over a TraceStore + the flight recorder.

    Every helper tolerates ``ctx=None`` (tracing off, or a request minted
    while the flag was off) as a cheap no-op, so call sites never branch
    on the flag themselves."""

    def __init__(self, store: Optional[TraceStore] = None):
        self.store = store if store is not None else TraceStore()

    # ------------------------------------------------------------- minting
    def start_trace(self, name: str, request_id: Optional[str] = None,
                    **fields) -> Optional[TraceContext]:
        if not tracing_enabled():
            return None
        tid = f"t{os.getpid():x}-{next(_trace_counter):06x}"
        ctx = TraceContext(tid, name, request_id=request_id)
        self.store.open(ctx, **fields)
        return ctx

    # ------------------------------------------------------------- records
    def record_span(self, ctx: Optional[TraceContext], name: str,
                    t_start: Optional[float] = None,
                    t_end: Optional[float] = None,
                    **fields) -> Optional[Span]:
        """Record a COMPLETED span in one call — the shape lifecycle edges
        use (queue wait, eviction, requeue...), so a crash between edge
        endpoints can never leak an open span."""
        if ctx is None:
            return None
        now = time.monotonic()
        sp = Span(ctx.trace_id, ctx.next_span_id(), name,
                  t_start=now if t_start is None else t_start,
                  fields=fields)
        sp.t_end = now if t_end is None else t_end
        self._commit(sp)
        return sp

    def begin_span(self, ctx: Optional[TraceContext], name: str,
                   parent_id: Optional[str] = None,
                   **fields) -> Optional[Span]:
        """Open a span; the caller must close it with ``end_span`` on
        every path."""
        if ctx is None:
            return None
        return Span(ctx.trace_id, ctx.next_span_id(), name,
                    parent_id=parent_id, fields=fields)

    def end_span(self, span: Optional[Span], **fields) -> None:
        if span is None:
            return
        span.t_end = time.monotonic()
        if fields:
            span.fields.update(fields)
        self._commit(span)

    @contextmanager
    def span(self, ctx: Optional[TraceContext], name: str, **fields):
        # bound inside the try so an exception in the open still routes
        # through the finally (end_span tolerates None)
        sp = None
        try:
            sp = self.begin_span(ctx, name, **fields)
            yield sp
        finally:
            self.end_span(sp)

    def _commit(self, span: Span) -> None:
        self.store.add(span)
        from .flight_recorder import get_flight_recorder

        get_flight_recorder().note(
            "trace", span.name, trace=span.trace_id, span=span.span_id,
            ms=None if span.duration_ms is None
            else round(span.duration_ms, 3), **span.fields)


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer; store bounds come from the FLAGS registry
    at first use (reconfigure by replacing the store's limits directly)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                from ..framework.flags import flag

                _tracer = Tracer(TraceStore(
                    capacity=int(flag("FLAGS_trace_store_capacity")),
                    max_spans=int(flag("FLAGS_trace_max_spans"))))
    return _tracer
