"""Counters, gauges and histograms (reference subset of
``paddle_tpu/observability/metrics.py``).

Only what the port's serving engine and queue, its fused optimizer
update (``fused_bucket_updates_total``), its gradient wire
(``collectives_total``, the four ``grad_comm_*`` families) and its
parameter-server communicator (``ps_rpcs_total`` by op) use:
labelled families, cumulative bucket histograms with Prometheus-style
quantile estimates, a JSON-safe snapshot and a reset. Exemplars, text exposition and JSONL export stay
in the reference until a later slice needs them. Pure stdlib.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


class Counter:
    """Monotonically increasing count."""

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

    def reset(self):
        self.value = 0

    def get(self):
        return self.value


class Histogram:
    """Cumulative-bucket histogram: each bucket counts observations <= its
    upper bound; +Inf is implicit (== count)."""

    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max")
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

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """q-quantile estimate, interpolated inside the first bucket whose
        cumulative count covers ``q * count`` and clamped to the observed
        [min, max] (the +Inf bucket answers with the max)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        if not self.count:
            return None
        target = q * self.count
        prev_c = 0
        for i, (b, c) in enumerate(zip(self.bounds, self.bucket_counts)):
            if c >= target and c > prev_c:
                lo = (self.bounds[i - 1] if i else
                      (self.min if self.min < b else 0.0))
                est = lo + (b - lo) * (target - prev_c) / (c - prev_c)
                break
            prev_c = c
        else:
            est = self.max
        return max(self.min, min(self.max, est))

    def get(self):
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named metric family; ``labels(**kv)`` returns the child for one
    label combination, an unlabelled family is its own single child."""

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Sequence[str] = (), **kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._kw = kw
        self._children: Dict[Tuple, object] = {}
        self._lock = threading.Lock()
        if not self.label_names:
            self._children[()] = _KINDS[kind](**kw)

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(f"metric {self.name!r} expects labels "
                             f"{self.label_names}, got {tuple(kv)}")
        key = tuple(sorted((str(k), str(v)) for k, v in kv.items()))
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _KINDS[self.kind](**self._kw))
        return child

    def _solo(self):
        if self.label_names:
            raise ValueError(f"metric {self.name!r} is labelled "
                             f"{self.label_names}; use .labels(...)")
        return self._children[()]

    def inc(self, n=1):
        self._solo().inc(n)

    def set(self, v):
        self._solo().set(v)

    def observe(self, v):
        self._solo().observe(v)

    def get(self):
        return self._solo().get()

    def reset(self):
        for c in self._children.values():
            c.reset()

    def items(self):
        return [(dict(k), c) for k, c in sorted(self._children.items())]


class MetricsRegistry:
    """Named families; declaring an existing name with the same kind and
    labels returns the existing family, a clash raises."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _declare(self, name, kind, help, labels, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    name, kind, help=help, label_names=labels, **kw)
        if fam.kind != kind or fam.label_names != tuple(labels):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.kind}{fam.label_names}")
        return fam

    def counter(self, name, help="", labels=()):
        return self._declare(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()):
        return self._declare(name, "gauge", help, labels)

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        return self._declare(name, "histogram", help, labels,
                             buckets=buckets)

    def get(self, name) -> Optional[_Family]:
        return self._families.get(name)

    def snapshot(self) -> dict:
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            if not fam.label_names:
                out[name] = fam.get()
            else:
                out[name] = {",".join(f"{k}={v}" for k, v in
                                      sorted(lbl.items())): child.get()
                             for lbl, child in fam.items()}
        return out

    def reset(self):
        for fam in self._families.values():
            fam.reset()


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry
