"""Counters, gauges and histograms (reference:
``paddle_tpu/observability/metrics.py``).

Process-global labelled families, fed by the port's serving engine,
queue and replica set, its fused optimizer update
(``fused_bucket_updates_total``), its gradient wire
(``collectives_total``, the ``grad_comm_*`` families), its
parameter-server communicator (``ps_rpcs_total`` by op) and the
robustness layer (watchdog and integrity counters). Cumulative bucket
histograms with Prometheus-style quantile estimates and OpenMetrics
exemplars (a trace id on the tightest bucket an observation landed in),
a JSON-safe ``snapshot``, the merge-ready ``typed_snapshot``, the
Prometheus text format 0.0.4 with its label-value and HELP escaping
(``to_prometheus``), JSONL export and ``reset``. Re-declaring a name
returns the existing family when kind and label names match, and raises
otherwise. ``Counter.inc`` is a plain attribute add. Pure stdlib.

    reg = get_registry()
    reg.counter("grad_comm_bytes_total", labels=("codec", "path")).labels(
        codec="int8_block", path="eager").inc(249344)
    reg.histogram("serve_ttft_ms").observe(12.5, exemplar=trace_id)
    reg.to_prometheus()
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_BUCKETS",
]

# latency-oriented default buckets (seconds): 1ms .. 60s, log-ish spacing
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v) -> str:
    """Prometheus exposition format 0.0.4 label-value escaping: backslash,
    double-quote, and line-feed must be escaped or the scrape line is
    malformed (a quote in the value would terminate it early)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(h) -> str:
    """HELP text escaping (0.0.4): backslash and line-feed only."""
    return str(h).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Dict) -> str:
    """`{k="v",...}` with 0.0.4 escaping; empty string for no labels."""
    if not labels:
        return ""
    return ("{" + ",".join(f'{k}="{_escape_label_value(v)}"'
                           for k, v in sorted(labels.items())) + "}")


def _fmt_exemplar(ex) -> str:
    """OpenMetrics exemplar suffix for a _bucket line: empty string when the
    bucket has none, else ` # {trace_id="..."} value`."""
    if ex is None:
        return ""
    value, trace_id = ex
    return f' # {{trace_id="{_escape_label_value(trace_id)}"}} {value}'


class Counter:
    """Monotonically increasing count. ``inc`` is hot-path cheap."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def reset(self):
        self.value = 0

    def get(self):
        return self.value


class Gauge:
    """A value that goes up and down."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def inc(self, n=1):
        self.value += n

    def dec(self, n=1):
        self.value -= n

    def reset(self):
        self.value = 0

    def get(self):
        return self.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics): each bucket
    counts observations <= its upper bound; +Inf is implicit (== count)."""

    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max",
                 "exemplars")
    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.reset()

    def reset(self):
        self.bucket_counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        # last exemplar per bucket (tightest covering bound; final slot is
        # the implicit +Inf bucket): (observed_value, trace_id) or None
        self.exemplars = [None] * (len(self.bounds) + 1)

    def observe(self, v, exemplar=None):
        """Record one observation. ``exemplar`` (a trace id string) tags the
        tightest bucket covering ``v`` so a scraped p99 bucket links back to
        the concrete request trace that landed there (OpenMetrics-style;
        exemplars stay OUT of typed_snapshot so cross-rank merge is
        unchanged)."""
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        tight = len(self.bounds)  # +Inf slot unless a finite bound covers v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                if i < tight:
                    tight = i
        if exemplar is not None:
            self.exemplars[tight] = (v, str(exemplar))

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float):
        """Estimate the q-quantile (0..1) from the cumulative buckets.

        Prometheus `histogram_quantile` semantics: find the first bucket
        whose cumulative count covers q*count and interpolate linearly
        inside it. Observations beyond the last finite bound live in the
        implicit +Inf bucket, where the best estimate is the observed max.
        The estimate is clamped to the observed [min, max] so a coarse
        bucket layout cannot report a value no observation ever had."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        if not self.count:
            return None
        target = q * self.count
        prev_c = 0
        for b, c in zip(self.bounds, self.bucket_counts):
            if c >= target and c > prev_c:
                lo = self._prev_bound(b)
                est = lo + (b - lo) * (target - prev_c) / (c - prev_c)
                break
            prev_c = c
        else:
            est = self.max  # target falls in the +Inf bucket
        if self.min is not None:
            est = max(self.min, min(self.max, est))
        return est

    def _prev_bound(self, bound):
        i = self.bounds.index(bound)
        if i > 0:
            return self.bounds[i - 1]
        # lowest bucket: interpolate from the observed min when we have one
        return self.min if self.min is not None and self.min < bound else 0.0

    def get(self):
        out = {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "buckets": {str(b): c
                        for b, c in zip(self.bounds, self.bucket_counts)},
        }
        ex = {}
        for i, e in enumerate(self.exemplars):
            if e is not None:
                bound = (str(self.bounds[i]) if i < len(self.bounds)
                         else "+Inf")
                ex[bound] = {"value": e[0], "trace_id": e[1]}
        if ex:
            out["exemplars"] = ex
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named metric family, optionally labelled. With ``label_names``,
    ``labels(**kv)`` returns (creating on first use) the child metric for
    that label combination; without, the family IS the single child."""

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Sequence[str] = (), **kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._kw = kw
        self._children: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        if not self.label_names:
            self._children[()] = _KINDS[kind](**kw)

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.label_names}, "
                f"got {tuple(kv)}")
        key = _label_key(kv)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _KINDS[self.kind](**self._kw))
        return child

    def bind(self, **kv):
        """The raw child metric (this combo's, or the unlabelled one) for
        hot-path use: callers keep the reference and pay a plain attribute
        add per event. reset() mutates children in place, so bound
        references stay live across registry resets."""
        return self.labels(**kv) if self.label_names else self._children[()]

    # unlabelled convenience passthrough
    def _solo(self):
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labelled {self.label_names}; "
                f"use .labels(...)")
        return self._children[()]

    def inc(self, n=1):
        self._solo().inc(n)

    def dec(self, n=1):
        self._solo().dec(n)

    def set(self, v):
        self._solo().set(v)

    def observe(self, v, exemplar=None):
        self._solo().observe(v, exemplar=exemplar)

    def quantile(self, q):
        return self._solo().quantile(q)

    def get(self):
        return self._solo().get()

    @property
    def value(self):
        return self._solo().value

    def reset(self):
        for c in self._children.values():
            c.reset()

    def items(self):
        """[(labels_dict, child), ...] snapshot-ordered."""
        return [(dict(k), c) for k, c in sorted(self._children.items())]


class MetricsRegistry:
    """Named families; idempotent declaration (same name + kind returns the
    existing family, a kind clash raises)."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ declare
    def _declare(self, name, kind, help, labels, **kw):
        fam = self._families.get(name)
        if fam is not None:
            return self._check_redeclare(fam, kind, labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    name, kind, help=help, label_names=labels, **kw)
                return fam
        return self._check_redeclare(fam, kind, labels)

    @staticmethod
    def _check_redeclare(fam, kind, labels):
        """Idempotent re-declaration must actually match: a kind clash OR a
        label-name mismatch raises (silently ignoring differing labels=
        would hand the caller a family whose .labels() rejects every inc)."""
        if fam.kind != kind:
            raise ValueError(
                f"metric {fam.name!r} already registered as {fam.kind}")
        if tuple(labels) != fam.label_names:
            raise ValueError(
                f"metric {fam.name!r} already registered with labels "
                f"{fam.label_names}, re-declared with {tuple(labels)}")
        return fam

    def counter(self, name, help="", labels=()):
        return self._declare(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()):
        return self._declare(name, "gauge", help, labels)

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        return self._declare(name, "histogram", help, labels, buckets=buckets)

    def get(self, name) -> Optional[_Family]:
        return self._families.get(name)

    def names(self):
        return sorted(self._families)

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-safe {name: value | {label_str: value}} view. Histograms
        render as their stats dict."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            if not fam.label_names:
                out[name] = fam.get()
            else:
                out[name] = {
                    ",".join(f"{k}={v}" for k, v in sorted(lbl.items())):
                        child.get()
                    for lbl, child in fam.items()
                }
        return out

    def reset(self):
        for fam in self._families.values():
            fam.reset()

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 (label values and HELP
        text escaped per the spec)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for lbl, child in (fam.items() if fam.label_names
                               else [({}, fam._solo())]):
                sfx = _fmt_labels(lbl)
                if fam.kind == "histogram":
                    # bucket_counts are already cumulative (observe() adds
                    # to every bucket whose bound covers the value); buckets
                    # holding an exemplar render the OpenMetrics-style
                    # ` # {trace_id="..."} value` suffix
                    for i, (b, c) in enumerate(zip(child.bounds,
                                                   child.bucket_counts)):
                        lines.append(f"{name}_bucket"
                                     f"{_fmt_labels(dict(lbl, le=b))} {c}"
                                     f"{_fmt_exemplar(child.exemplars[i])}")
                    lines.append(f"{name}_bucket"
                                 f"{_fmt_labels(dict(lbl, le='+Inf'))} "
                                 f"{child.count}"
                                 f"{_fmt_exemplar(child.exemplars[-1])}")
                    lines.append(f"{name}_sum{sfx} {child.sum}")
                    lines.append(f"{name}_count{sfx} {child.count}")
                else:
                    lines.append(f"{name}{sfx} {child.value}")
        return "\n".join(lines) + "\n"

    def typed_snapshot(self) -> dict:
        """Merge-ready snapshot: unlike snapshot(), keeps the metric KIND
        and the raw per-child state (histograms as bounds + cumulative
        bucket counts), so the cross-rank aggregator (aggregate.py) can
        apply per-kind reduction rules instead of guessing from shapes.

            {name: {"kind", "help", "labels": [...],
                    "children": {label_str: raw_state}}}
        """
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            children = {}
            for lbl, child in (fam.items() if fam.label_names
                               else [({}, fam._solo())]):
                key = ",".join(f"{k}={v}" for k, v in sorted(lbl.items()))
                if fam.kind == "histogram":
                    children[key] = {
                        "bounds": list(child.bounds),
                        "bucket_counts": list(child.bucket_counts),
                        "count": child.count, "sum": child.sum,
                        "min": child.min, "max": child.max,
                    }
                else:
                    children[key] = child.value
            out[name] = {"kind": fam.kind, "help": fam.help,
                         "labels": list(fam.label_names),
                         "children": children}
        return out

    def export_jsonl(self, path) -> dict:
        """Append one timestamped snapshot line; returns the record."""
        rec = {"time": time.time(), "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every built-in subsystem reports into."""
    return _global_registry
