"""Structured event log: append-only JSONL with severity and rank
(reference: ``paddle_tpu/observability/events.py``).

The metrics registry answers "how many / how long"; the event log
answers "what happened, in what order": replica evictions and scale
events, watchdog stalls, integrity divergences, PS RPCs under
``FLAGS_enable_rpc_profiler``. Each record carries a wall-clock
timestamp, a monotonic one and the process rank (the port's
``distributed.env.get_rank``):

    {"time": 1722..., "mono": 123.45, "severity": "info",
     "kind": "serving", "rank": 0, "message": "...", ...fields...}

An ``EventLog`` keeps a bounded in-memory ring (``dropped`` counts what
fell off it) and, given a path, appends each record to that JSONL file
as it is logged, flushed a line. Module-level sinks (``add_event_sink``)
see every record of every log; the flight recorder is one. A sink that
raises is counted in ``sink_faults``, never re-raised. Host code only.
"""
from __future__ import annotations

import json
import os
import threading
import time
import traceback
from collections import deque
from typing import Optional

__all__ = ["EventLog", "SEVERITIES", "get_event_log", "set_event_log",
           "add_event_sink", "remove_event_sink"]

SEVERITIES = ("debug", "info", "warning", "error")

# module-level sinks: called as sink(record_dict) for every record logged on
# ANY EventLog (the flight recorder subscribes here — it must keep seeing
# events even after set_event_log swaps the global instance)
_event_sinks = []


def add_event_sink(sink):
    _event_sinks.append(sink)
    return sink


def remove_event_sink(sink):
    try:
        _event_sinks.remove(sink)
    except ValueError:
        pass


def _current_rank() -> int:
    # lazy: the distributed env loads torch.distributed
    try:
        from ..distributed.env import get_rank

        return int(get_rank())
    except Exception:
        return int(os.environ.get("RANK", 0))


class EventLog:
    def __init__(self, path: Optional[str] = None, max_memory: int = 10000,
                 rank: Optional[int] = None):
        self.path = str(path) if path else None
        self.rank = rank
        self._ring = deque(maxlen=max_memory)
        self._lock = threading.Lock()
        self._file = None
        self.dropped = 0
        self.sink_faults = 0                 # broken-sink count (see log())
        self.last_sink_error: Optional[str] = None
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._file = open(self.path, "a")

    # ---------------------------------------------------------------- log
    def log(self, kind: str, message: str = "", severity: str = "info",
            **fields) -> dict:
        if severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {severity!r}")
        rec = {
            "time": time.time(),
            "mono": time.monotonic(),
            "severity": severity,
            "kind": str(kind),
            "rank": self.rank if self.rank is not None else _current_rank(),
        }
        if message:
            rec["message"] = str(message)
        rec.update(fields)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
            if self._file is not None:
                try:
                    self._file.write(json.dumps(rec) + "\n")
                    self._file.flush()
                except (OSError, ValueError):
                    pass  # a full/closed disk must never sink training
        for sink in _event_sinks:
            try:
                sink(rec)
            except Exception:
                # a broken sink must never sink training — but the fault is
                # counted and kept inspectable, not silently dropped: this
                # log IS the recorder of last resort, so it records onto
                # itself rather than recursing through log()
                self.sink_faults += 1
                self.last_sink_error = traceback.format_exc(limit=4)
        return rec

    def debug(self, kind, message="", **fields):
        return self.log(kind, message, severity="debug", **fields)

    def info(self, kind, message="", **fields):
        return self.log(kind, message, severity="info", **fields)

    def warning(self, kind, message="", **fields):
        return self.log(kind, message, severity="warning", **fields)

    def error(self, kind, message="", **fields):
        return self.log(kind, message, severity="error", **fields)

    # -------------------------------------------------------------- query
    def events(self, kind=None, severity=None, min_severity=None):
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if severity is not None:
            evs = [e for e in evs if e["severity"] == severity]
        if min_severity is not None:
            floor = SEVERITIES.index(min_severity)
            evs = [e for e in evs
                   if SEVERITIES.index(e["severity"]) >= floor]
        return evs

    def tail(self, n=20):
        with self._lock:
            return list(self._ring)[-n:]

    def __len__(self):
        return len(self._ring)

    # ------------------------------------------------------------- export
    def export(self, path):
        """Write the in-memory ring to a fresh JSONL file."""
        with self._lock:
            evs = list(self._ring)
        with open(path, "w") as f:
            for rec in evs:
                f.write(json.dumps(rec) + "\n")
        return path

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                finally:
                    self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_global_log = EventLog()


def get_event_log() -> EventLog:
    """The process-global event log the built-in subsystems report into."""
    return _global_log


def set_event_log(log: EventLog) -> EventLog:
    """Swap the global event log (e.g. to attach a file sink); returns the
    previous one so callers can restore it."""
    global _global_log
    prev = _global_log
    _global_log = log
    return prev
