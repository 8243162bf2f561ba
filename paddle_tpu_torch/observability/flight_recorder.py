"""Always-on flight recorder: a bounded ring of what just happened
(reference: ``paddle_tpu/observability/flight_recorder.py``).

When a job hangs or trips, the question is what this rank did last. The
recorder keeps a bounded ring of recent

- **events**: every ``EventLog`` record (a module-level event sink):
  evictions, watchdog stalls, integrity divergences;
- **trace spans**: every span the tracer commits (kind "trace");
- **lane entries**: collective-lane activity recorded explicitly by
  ``distributed/overlap.py`` and ``distributed/sharding/stage3.py``
  (which bucket launched, started, ended or failed on which group).

A note is one dict build and one ``deque.append`` (no lock; ``maxlen``
bounds memory). On an escalation (``HangDetector`` stall or escalate,
``NanGuard`` trip, ``ReplicaGuard`` divergence) the subsystem calls
``dump_flight_recorder(reason)`` and the ring is written to a
postmortem JSON in ``FLAGS_flight_recorder_dir``, else in
``<tmpdir>/paddle_tpu_flightrec``; never in the checkout.
``FLAGS_flight_recorder_capacity`` sets the depth (0 disables it).

Not ported: the reference's tap of profiler spans (``_install`` adds
``_on_span`` to ``paddle_tpu.profiler``'s span sinks). It waits for the
port of ``profiler`` (ROADMAP Queue A 14); ``_on_span`` is kept for it.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["FlightRecorder", "get_flight_recorder", "dump_flight_recorder",
           "configure_flight_recorder", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 4096
_MAX_AUTO_DUMPS = 16    # postmortem storms must not fill the disk


def _flag(name, default):
    try:
        from ..framework.flags import flag

        v = flag(name)
        return default if v is None else v
    except Exception:
        return default


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None,
                 dump_dir: Optional[str] = None, rank: Optional[int] = None):
        if capacity is None:
            capacity = int(_flag("FLAGS_flight_recorder_capacity",
                                 DEFAULT_CAPACITY))
        self.capacity = int(capacity)
        self._ring = deque(maxlen=max(1, self.capacity))
        self.enabled = self.capacity > 0
        self.dump_dir = dump_dir
        self.rank = rank
        self.dumps: List[dict] = []
        self._dump_lock = threading.Lock()
        self._seq = 0

    # ----------------------------------------------------------- recording
    def note(self, kind: str, name: str, **fields):
        """One ring entry; the hot path is a dict build + deque append."""
        if not self.enabled:
            return
        rec = {"mono": time.monotonic(), "kind": kind, "name": name}
        if fields:
            rec.update(fields)
        self._ring.append(rec)

    def lane(self, name: str, **fields):
        """Collective-lane activity (bucket launches, attempt starts) —
        the entries a hang postmortem is read for."""
        self.note("lane", name, **fields)

    # sink adapters ---------------------------------------------------------
    def _on_span(self, name, start_ns, end_ns, tid):
        if not self.enabled:
            return
        self._ring.append({
            "mono": time.monotonic(), "kind": "span", "name": name,
            "dur_us": (end_ns - start_ns) / 1e3, "tid": tid,
        })

    def _on_event(self, rec: dict):
        if not self.enabled:
            return
        self._ring.append({
            "mono": rec.get("mono", time.monotonic()), "kind": "event",
            "name": rec.get("kind", "?"),
            "severity": rec.get("severity"),
            "message": rec.get("message", ""),
            "fields": {k: v for k, v in rec.items()
                       if k not in ("mono", "time", "kind", "severity",
                                    "message")},
        })

    # -------------------------------------------------------------- queries
    def entries(self, n: Optional[int] = None, kind: Optional[str] = None):
        evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs[-n:] if n else evs

    def __len__(self):
        return len(self._ring)

    def clear(self):
        self._ring.clear()

    # ----------------------------------------------------------------- dump
    def _rank(self) -> int:
        if self.rank is not None:
            return self.rank
        try:
            from ..distributed.env import get_rank

            return int(get_rank())
        except Exception:
            return int(os.environ.get("RANK", 0))

    def _dump_dir(self) -> str:
        d = (self.dump_dir
             or str(_flag("FLAGS_flight_recorder_dir", "") or "")
             or os.path.join(tempfile.gettempdir(), "paddle_tpu_flightrec"))
        os.makedirs(d, exist_ok=True)
        return d

    def dump(self, reason: str, path: Optional[str] = None,
             auto: bool = False) -> Optional[str]:
        """Write the ring (oldest→newest) to a postmortem JSON; returns the
        path (None when recording is disabled or the auto-dump budget is
        spent). Never raises — a postmortem writer that can take down the
        process it is documenting is worse than none."""
        if not self.enabled:
            return None
        with self._dump_lock:
            if auto and len(self.dumps) >= _MAX_AUTO_DUMPS:
                return None
            self._seq += 1
            seq = self._seq
            entries = list(self._ring)
        rank = self._rank()
        try:
            if path is None:
                path = os.path.join(
                    self._dump_dir(),
                    f"flightrec_rank{rank}_{os.getpid()}_{seq:03d}.json")
            rec = {
                "reason": str(reason),
                "time": time.time(),
                "mono": time.monotonic(),
                "rank": rank,
                "pid": os.getpid(),
                "capacity": self.capacity,
                "n_entries": len(entries),
                "entries": entries,
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            os.replace(tmp, path)
        except Exception:
            return None
        self.dumps.append({"reason": str(reason), "path": path,
                           "time": rec["time"]})
        return path


# ---------------------------------------------------------------------------
# the process-global, always-on instance
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_install_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The global recorder; created (and its span/event sinks installed)
    on first use."""
    global _recorder
    if _recorder is None:
        with _install_lock:
            if _recorder is None:
                _recorder = _install(FlightRecorder())
    return _recorder


def configure_flight_recorder(capacity: Optional[int] = None,
                              dump_dir: Optional[str] = None
                              ) -> FlightRecorder:
    """Replace the global recorder (depth / dump-dir change). The old
    ring's entries are dropped — reconfigure before the interesting part."""
    global _recorder
    with _install_lock:
        old = _recorder
        if old is not None:
            _uninstall(old)
        _recorder = _install(FlightRecorder(capacity=capacity,
                                            dump_dir=dump_dir))
    return _recorder


def _install(rec: FlightRecorder) -> FlightRecorder:
    from . import events as _events

    _events.add_event_sink(rec._on_event)
    return rec


def _uninstall(rec: FlightRecorder):
    from . import events as _events

    _events.remove_event_sink(rec._on_event)


def dump_flight_recorder(reason: str, auto: bool = True) -> Optional[str]:
    """Escalation-path entry point (HangDetector / NanGuard breaker /
    ReplicaGuard): dump the global ring. No-throw; returns the dump path
    or None."""
    try:
        return get_flight_recorder().dump(reason, auto=auto)
    except Exception:
        return None
