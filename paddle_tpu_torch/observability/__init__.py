"""paddle_tpu_torch.observability: telemetry (reference:
``paddle_tpu/observability``).

- ``MetricsRegistry`` (metrics.py): process-global labelled counters,
  gauges and histograms (exemplars), ``snapshot``, ``typed_snapshot``,
  Prometheus text and JSONL export.
- ``EventLog`` (events.py): append-only structured records with
  severity, monotonic and wall timestamps and the rank; event sinks.
- ``Tracer`` / ``TraceStore`` (tracing.py): request-scoped spans of the
  serving path, one trace a request across evictions.
- ``FlightRecorder`` (flight_recorder.py): an always-on bounded ring of
  events, trace spans and collective-lane entries, dumped on an
  escalation.
- ``TelemetryServer`` (exposition.py): /metrics, /snapshot, /events,
  /flightrecorder, /healthz and registered sections over HTTP on
  loopback; ``parse_prometheus_text``.

``FLAGS_enable_rpc_profiler`` (``framework/flags.py``) turns on
``enable_rpc_event_log``: the PS communicator then writes a "ps_rpc"
event a push or pull, as the reference's does.

Not ported (ROADMAP Queue A 9b): ``aggregate.py`` (the cross-rank
aggregate), ``memory.py``, ``step_timer.py`` and the flight recorder's
tap of profiler spans, which wait for the port of ``profiler``.
"""
from __future__ import annotations

from .events import (  # noqa: F401
    SEVERITIES, EventLog, add_event_sink, get_event_log, remove_event_sink,
    set_event_log,
)
from .exposition import (  # noqa: F401
    TelemetryServer, get_telemetry_server, parse_prometheus_text,
    register_section, start_exposition, stop_exposition,
    unregister_section,
)
from .flight_recorder import (  # noqa: F401
    FlightRecorder, configure_flight_recorder, dump_flight_recorder,
    get_flight_recorder,
)
from .metrics import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, get_registry,
)
from .tracing import (  # noqa: F401
    Span, TraceContext, TraceStore, Tracer, get_tracer, tracing_enabled,
)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "get_registry",
    "DEFAULT_BUCKETS",
    "EventLog", "SEVERITIES", "get_event_log", "set_event_log",
    "add_event_sink", "remove_event_sink",
    "rpc_profiler_enabled", "enable_rpc_event_log",
    "FlightRecorder", "get_flight_recorder", "dump_flight_recorder",
    "configure_flight_recorder",
    "TelemetryServer", "start_exposition", "stop_exposition",
    "get_telemetry_server", "parse_prometheus_text",
    "register_section", "unregister_section",
    "TraceContext", "Span", "TraceStore", "Tracer", "get_tracer",
    "tracing_enabled",
]


def _flag_on() -> bool:
    from ..framework.flags import flag

    return bool(flag("FLAGS_enable_rpc_profiler"))


# FLAGS_enable_rpc_profiler: read once here (its environment variable
# included), then set by framework.flags.set_flags
_rpc_profiler = {"enabled": _flag_on()}


def rpc_profiler_enabled() -> bool:
    return _rpc_profiler["enabled"]


def enable_rpc_event_log(enabled: bool = True):
    """Toggle the per-RPC event log (FLAGS_enable_rpc_profiler)."""
    _rpc_profiler["enabled"] = bool(enabled)
    return get_event_log()
