"""Live telemetry exposition: a stdlib HTTP endpoint per rank
(reference: ``paddle_tpu/observability/exposition.py``).

    GET /metrics          Prometheus text exposition (format 0.0.4)
    GET /snapshot         JSON registry snapshot (this rank's)
    GET /events?n=100     newest event-log records (JSON)
    GET /flightrecorder   the flight-recorder ring (JSON)
    GET /healthz          liveness probe ("ok"; ?verbose=1 lists paths)
    GET /<section>[/<id>] registered sections: a ``ReplicaSet`` mounts
                          /serving and /traces (/traces/<trace id>)
                          while it runs

``TelemetryServer(port=0).start()`` binds an ephemeral port on
127.0.0.1 (``.port``, ``.url``); ``start_exposition()`` starts the
global one on ``FLAGS_telemetry_http_port`` (0, the default, means
off). The server is a daemon ``ThreadingHTTPServer`` whose handlers
only read in-memory state; it listens on loopback unless a host is
given. ``parse_prometheus_text`` is the strict parser the tests scrape
through: it rejects malformed lines (bad escapes, unquoted labels, type
clashes, malformed exemplars).

Not ported: the cross-rank aggregate behind /snapshot (the reference's
``aggregate.py`` ``MetricsAggregator``); an ``aggregator=`` raises
``NotImplementedError`` naming "replicas and tracing" (ROADMAP Queue A
9b).
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .events import get_event_log
from .metrics import get_registry

__all__ = ["TelemetryServer", "start_exposition", "stop_exposition",
           "get_telemetry_server", "parse_prometheus_text",
           "register_section", "unregister_section"]

# pluggable JSON sections (path "/<name>"): subsystems register a
# zero-arg provider returning a JSON-safe dict; the serving runtime
# mounts "/serving" while a ReplicaSet is running. A section may also
# carry a subpath provider ("/traces/<id>"): a one-arg callable handed
# the remainder of the path, returning a JSON-safe dict or None (404).
# Read-only, like every other route; provider errors surface as the
# handler's 500 envelope. _state_lock guards this module's mutable
# globals (the section map and the start/stop_exposition _server swap).
_sections: dict = {}
_state_lock = threading.Lock()


def register_section(name: str, provider, subpath_provider=None):
    with _state_lock:
        _sections[name] = (provider, subpath_provider)


def unregister_section(name: str):
    with _state_lock:
        _sections.pop(name, None)


def _known_paths():
    """Every servable path, static routes plus whatever sections are
    registered right now: the one source for /healthz?verbose and the
    404 listing."""
    with _state_lock:
        dynamic = sorted("/" + s for s in _sections)
    return ["/metrics", "/snapshot", "/events", "/flightrecorder",
            "/healthz"] + dynamic


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-torch-telemetry/1.0"

    # ------------------------------------------------------------ plumbing
    def log_message(self, fmt, *args):  # no stderr chatter per scrape
        pass

    def _send(self, code, body, content_type):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, obj, code=200):
        self._send(code, json.dumps(obj, indent=1, default=str),
                   "application/json")

    # ------------------------------------------------------------- routes
    def do_GET(self):
        srv: "TelemetryServer" = self.server._telemetry  # type: ignore
        url = urlparse(self.path)
        q = parse_qs(url.query)
        try:
            if url.path == "/metrics":
                self._send(200, srv.registry.to_prometheus(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif url.path == "/snapshot":
                self._json(srv.snapshot(local="local" in q))
            elif url.path == "/events":
                n = int(q.get("n", ["100"])[0])
                self._json({"events": srv.event_log().tail(n)})
            elif url.path == "/flightrecorder":
                n = int(q.get("n", ["0"])[0]) or None
                rec = srv.flight_recorder()
                self._json({"capacity": rec.capacity,
                            "n_entries": len(rec),
                            "dumps": rec.dumps,
                            "entries": rec.entries(n)})
            elif url.path == "/healthz":
                # bare probe stays a plain "ok" (liveness contract);
                # ?verbose=1 also lists every live path, dynamically
                # registered sections included
                if "verbose" in q:
                    self._json({"status": "ok", "paths": _known_paths()})
                else:
                    self._send(200, "ok\n", "text/plain")
            elif self._section(url.path):
                pass  # handled (response already sent)
            else:
                self._json({"error": f"unknown path {url.path!r}",
                            "paths": _known_paths()},
                           code=404)
        except Exception as e:  # a handler bug must not kill the server
            self._json({"error": repr(e)}, code=500)

    def _section(self, path: str) -> bool:
        """Dispatch "/<section>" and "/<section>/<sub>" to a registered
        provider. Returns True when the path named a live section (the
        response — 200 or a section-local 404 — has been sent)."""
        parts = path.lstrip("/").split("/", 1)
        with _state_lock:
            entry = _sections.get(parts[0])
        if entry is None:
            return False
        provider, sub_provider = entry
        if len(parts) == 1 or not parts[1]:
            self._json(provider())
            return True
        if sub_provider is None:
            self._json({"error": f"section {parts[0]!r} has no "
                                 f"sub-resources"}, code=404)
            return True
        obj = sub_provider(parts[1])
        if obj is None:
            self._json({"error": f"unknown {parts[0]} id {parts[1]!r}"},
                       code=404)
        else:
            self._json(obj)
        return True


AGGREGATE_ITEM = ("the cross-rank metrics aggregate (ROADMAP Queue A 9b, "
                  "'replicas and tracing')")


def _no_aggregator(aggregator) -> None:
    if aggregator is not None:
        raise NotImplementedError(
            f"aggregator=: {AGGREGATE_ITEM} is not ported")


class TelemetryServer:
    """Per-rank telemetry HTTP server (daemon threads; reads only)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None, aggregator=None, event_log=None,
                 flight_recorder=None):
        _no_aggregator(aggregator)
        self.host = host
        self.requested_port = int(port)
        self.port: Optional[int] = None
        self.registry = registry or get_registry()
        self.aggregator = aggregator
        self._event_log = event_log
        self._flight_recorder = flight_recorder
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # late-bound so the server always shows the CURRENT global instances
    def event_log(self):
        return self._event_log or get_event_log()

    def flight_recorder(self):
        if self._flight_recorder is not None:
            return self._flight_recorder
        from .flight_recorder import get_flight_recorder

        return get_flight_recorder()

    def snapshot(self, local: bool = False) -> dict:
        return {"aggregated": False, "metrics": self.registry.snapshot()}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._httpd._telemetry = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"telemetry-http-{self.port}")
        self._thread.start()
        get_event_log().info("telemetry", "exposition endpoint up",
                             host=self.host, port=self.port)
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    @property
    def url(self) -> Optional[str]:
        return f"http://{self.host}:{self.port}" if self.port else None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


_server: Optional[TelemetryServer] = None


def start_exposition(port: Optional[int] = None, aggregator=None,
                     host: str = "127.0.0.1") -> Optional[TelemetryServer]:
    """Start (or return) the global endpoint. `port` defaults to
    FLAGS_telemetry_http_port; 0/unset there means "off" and returns None,
    so callers can wire this unconditionally."""
    global _server
    _no_aggregator(aggregator)
    if _server is not None:
        return _server
    if port is None:
        from ..framework.flags import flag

        port = int(flag("FLAGS_telemetry_http_port") or 0)
        if port == 0:
            return None
    srv = TelemetryServer(port=port, host=host,
                          aggregator=aggregator).start()
    with _state_lock:
        _server = srv
    return srv


def stop_exposition():
    global _server
    if _server is not None:
        _server.stop()
        with _state_lock:
            _server = None


def get_telemetry_server() -> Optional[TelemetryServer]:
    return _server


# ---------------------------------------------------------------------------
# strict text-format parser (stdlib only)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"(?:,|$)')
# OpenMetrics-style exemplar tail on a sample line:  # {k="v",...} value
# Anchored at end-of-line with the full quoted-label grammar, so a "#"
# inside an (escaped) label value of the sample itself cannot false-match.
_EXEMPLAR_RE = re.compile(
    r' # \{(?P<labels>(?:[a-zA-Z_][a-zA-Z0-9_]*='
    r'"(?:[^"\\]|\\.)*",?)*)\} (?P<value>[^\s]+)$')


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\":
            if i + 1 >= len(v):
                raise ValueError(f"dangling backslash in label value {v!r}")
            nxt = v[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ValueError(f"invalid escape \\{nxt} in {v!r}")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prometheus_text(text: str) -> dict:
    """Strictly parse exposition format 0.0.4.

    Returns {family: {"type", "help", "samples": [(name, labels_dict,
    value), ...], "exemplars": [(name, labels_dict, exemplar_labels,
    exemplar_value), ...]}}. Samples stay 3-tuples (existing consumers
    unpack them); exemplar-annotated lines additionally land in the
    family's "exemplars" list. Raises ValueError on any malformed line —
    unparseable sample, bad label escape, malformed exemplar tail, sample
    naming a family whose TYPE was declared differently, non-float value.
    """
    families: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            if not _NAME_RE.fullmatch(parts[0]):
                raise ValueError(f"line {lineno}: bad HELP name {parts[0]!r}")
            families.setdefault(parts[0], {"type": None, "help": None,
                                           "samples": [], "exemplars": []})
            families[parts[0]]["help"] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2 or parts[1] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            fam = families.setdefault(parts[0], {"type": None, "help": None,
                                                 "samples": [], "exemplars": []})
            if fam["type"] is not None and fam["type"] != parts[1]:
                raise ValueError(
                    f"line {lineno}: family {parts[0]!r} re-TYPEd "
                    f"{fam['type']} -> {parts[1]}")
            fam["type"] = parts[1]
            continue
        if line.startswith("#"):
            continue  # comment
        # split an exemplar tail (` # {k="v"} value`) off before the sample
        # parse: the sample grammar itself has no "#"
        exemplar = None
        em = _EXEMPLAR_RE.search(line)
        if em is not None:
            ex_labels = _parse_label_block(em.group("labels").rstrip(","),
                                           lineno)
            try:
                ex_value = float(em.group("value"))
            except ValueError:
                raise ValueError(f"line {lineno}: non-numeric exemplar "
                                 f"value {em.group('value')!r}")
            exemplar = (ex_labels, ex_value)
            line = line[:em.start()]
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        name = m.group("name")
        labels = _parse_label_block(m.group("labels"), lineno)
        try:
            value = float(m.group("value").replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError:
            raise ValueError(
                f"line {lineno}: non-numeric value {m.group('value')!r}")
        # histogram child samples (<fam>_bucket/_sum/_count) attach to their
        # declared family
        fam_name = name
        for sfx in ("_bucket", "_sum", "_count"):
            base = name[:-len(sfx)] if name.endswith(sfx) else None
            if base and base in families and \
                    families[base]["type"] == "histogram":
                fam_name = base
                break
        fam = families.setdefault(fam_name, {"type": None, "help": None,
                                             "samples": [], "exemplars": []})
        fam["samples"].append((name, labels, value))
        if exemplar is not None:
            fam["exemplars"].append((name, labels) + exemplar)
    return families


def _parse_label_block(raw, lineno: int) -> dict:
    """Strictly parse a `k="v",...` block (sample labels and exemplar
    labels share the grammar). None/empty means no labels."""
    labels: dict = {}
    if not raw:
        return labels
    consumed = 0
    for lm in _LABEL_RE.finditer(raw):
        if lm.start() != consumed:
            raise ValueError(
                f"line {lineno}: malformed label block {raw!r}")
        labels[lm.group("key")] = _unescape_label(lm.group("val"))
        consumed = lm.end()
    if consumed != len(raw):
        raise ValueError(
            f"line {lineno}: trailing junk in label block {raw!r}")
    return labels
