"""Process-local metrics registry: counters, gauges, histograms.

The registry core and the Prometheus exporter of ``repro/obs/metrics.py``.
Host-side recording is plain Python arithmetic; eager PyTorch needs no
trace-time bridge, so callers (the qN stream counters, the carry cache, the
serving loop, the backward pass) write straight into it.  The registry
renders as Prometheus text (:meth:`MetricsRegistry.to_prom`), written
atomically (:meth:`MetricsRegistry.write_prom`) and refreshed by a
:class:`PromFlusher` thread.  The ``enabled`` switch gates only
:func:`emit_scalar`, whose value is a tensor: reading it is a host read,
made only when a launcher asked for metrics.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Mapping

import torch

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "PromFlusher",
           "default_registry", "emit_scalar", "enabled", "record_backward",
           "record_solve", "set_enabled"]

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

    def to_prom(self) -> str:
        """The registry in the Prometheus text exposition format: counters
        and gauges one line each; histograms the cumulative
        ``_bucket{le=...}`` series (always with a ``+Inf`` bucket) plus
        ``_sum``/``_count``.  Names are sanitised to the Prometheus charset
        and label values escaped."""
        with self._lock:
            items = sorted(self._metrics.items())
        groups: dict[str, list] = {}
        for (name, lk), m in items:
            groups.setdefault(name, []).append((lk, m))
        lines: list[str] = []
        for name, rows in groups.items():
            kind = rows[0][1].kind
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {kind}")
            for lk, m in rows:
                if m.kind != kind:
                    continue
                if kind != "histogram":
                    lines.append(
                        f"{pname}{_prom_labels(lk)} {_prom_num(m.value)}")
                    continue
                cum = 0
                for b, c in zip(m.buckets, m.counts):
                    cum += c
                    le = "+Inf" if b == float("inf") else _prom_num(b)
                    lines.append(f"{pname}_bucket"
                                 f"{_prom_labels(lk, ('le', le))} {cum}")
                if not m.buckets or m.buckets[-1] != float("inf"):
                    lines.append(f"{pname}_bucket"
                                 f"{_prom_labels(lk, ('le', '+Inf'))} "
                                 f"{m.count}")
                lines.append(
                    f"{pname}_sum{_prom_labels(lk)} {_prom_num(m.sum)}")
                lines.append(f"{pname}_count{_prom_labels(lk)} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prom(self, path: str) -> str:
        """Write :meth:`to_prom` atomically (a temporary file, then a
        rename), so a scrape of the file never sees a torn exposition."""
        text = self.to_prom()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
        return text


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return "_" + out if out[:1].isdigit() else out


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _prom_labels(lk: _LabelsKey, *extra: tuple[str, str]) -> str:
    pairs = list(lk) + list(extra)
    if not pairs:
        return ""
    esc = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}
    body = ",".join(
        f'{_prom_name(k)}="{"".join(esc.get(c, c) for c in str(v))}"'
        for k, v in pairs)
    return "{" + body + "}"


class PromFlusher:
    """A daemon thread that rewrites a Prometheus text file every
    ``interval_s`` seconds until :meth:`stop`, which flushes once more, so
    a short run still leaves a complete exposition behind."""

    def __init__(self, path: str, interval_s: float = 10.0,
                 registry: "MetricsRegistry | None" = None):
        self.path = path
        self.interval_s = float(interval_s)
        self.registry = registry or default_registry()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="prom-flusher", daemon=True)

    def start(self) -> "PromFlusher":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.registry.write_prom(self.path)

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        self.registry.write_prom(self.path)


_REGISTRY = MetricsRegistry()
_ENABLED = False


def default_registry() -> MetricsRegistry:
    return _REGISTRY


def set_enabled(on: bool) -> None:
    """Switch :func:`emit_scalar` on or off (off by default)."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def emit_scalar(name: str, value, *, labels=None, kind: str = "gauge") -> None:
    """Land a scalar (a number or a one-element tensor) in the registry:
    ``kind`` "gauge" sets, "counter" adds, "histogram" observes.  No-op,
    and no host read, when disabled."""
    if not _ENABLED:
        return
    v = float(value)
    if kind == "counter":
        _REGISTRY.counter(name, labels).inc(v)
    elif kind == "histogram":
        _REGISTRY.histogram(name, labels).observe(v)
    else:
        _REGISTRY.gauge(name, labels).set(v)


def snapshot() -> dict:
    """Snapshot of the default registry."""
    return _REGISTRY.snapshot()


def record_solve(phase: str, result) -> None:
    """Count one solve and its iterations under ``{phase}``."""
    pl = {"phase": phase}
    _REGISTRY.counter("solves_total", pl).inc()
    _REGISTRY.counter("solve_iters_total", pl).inc(int(result.n_steps))


def record_backward(estimator: str, adj) -> None:
    """One backward cotangent estimate (an ``AdjointResult``): estimates,
    iterations of its iterative part, mean finite residual and the samples
    whose fallback guard fired, under ``{estimator}``."""
    pl = {"estimator": estimator}
    _REGISTRY.counter("backward_estimates_total", pl).inc()
    _REGISTRY.counter("backward_iters_total", pl).inc(int(adj.n_steps))
    res = adj.residual.float()
    res = res[torch.isfinite(res)]
    if res.numel():
        _REGISTRY.histogram("backward_residual", pl).observe(
            float(res.mean()))
    _REGISTRY.counter("backward_fallbacks_total", pl).inc(
        int(adj.fallback_mask.sum()))
