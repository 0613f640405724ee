"""Process-local metrics registry: counters, gauges, histograms.

The registry core of ``repro/obs/metrics.py``.  Host-side recording is
plain Python arithmetic; eager PyTorch needs no trace-time bridge, so
callers (the qN stream counters, the carry cache, the serving loop) write
straight into it.  The Prometheus exposition and the solver telemetry
helpers come with later slices.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Mapping

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]

_LabelsKey = tuple[tuple[str, str], ...]

# ms-oriented default latency buckets; counters/gauges ignore them.
_DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                    250.0, 500.0, 1000.0, 2500.0, 5000.0, float("inf"))


def _labels_key(labels: Mapping[str, str] | None) -> _LabelsKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += float(v)

    def payload(self) -> dict:
        return {"value": self.value}


class Gauge:
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def payload(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus sum/count/min/max."""

    kind = "histogram"

    def __init__(self, buckets=_DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def payload(self) -> dict:
        return {
            "buckets": list(self.buckets), "counts": list(self.counts),
            "sum": self.sum, "count": self.count,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.sum / self.count if self.count else None,
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[tuple[str, _LabelsKey], object] = {}

    def _get(self, cls, name: str, labels, **kw):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(**kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{dict(key[1])} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, labels=None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels=None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels=None, buckets=None) -> Histogram:
        kw = {"buckets": buckets} if buckets is not None else {}
        return self._get(Histogram, name, labels, **kw)

    def snapshot(self) -> dict:
        with self._lock:
            metrics = [
                {"name": name, "labels": dict(lk), "kind": m.kind,
                 **m.payload()}
                for (name, lk), m in sorted(self._metrics.items())
            ]
        return {"schema": "repro.obs.metrics/v1", "unix_time": time.time(),
                "pid": os.getpid(), "metrics": metrics}


_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _REGISTRY


def snapshot() -> dict:
    """Snapshot of the default registry."""
    return _REGISTRY.snapshot()
