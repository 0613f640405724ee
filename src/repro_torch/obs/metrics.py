"""Process-local metrics registry and the bridge from the device.

The port of ``repro/obs/metrics.py``: counters, gauges, histograms and
series keyed by ``(name, labels)``, rendered as a JSON snapshot or as
Prometheus text (:meth:`MetricsRegistry.to_prom`, written atomically by
:meth:`MetricsRegistry.write_prom` and refreshed by a :class:`PromFlusher`
thread).

Host-side recording (serving counters, the prefix cache's records, qN
stream counters, checkpoint bytes) is plain Python arithmetic and
unconditional, as in the reference.
The bridge -- :func:`emit_scalar`, :func:`record_solve`,
:func:`record_backward` -- carries values computed on the device.  It is
gated on :func:`enabled` (off by default): switched off it returns at once
and reads nothing.  Switched on it still makes no host read of its own: it
keeps the detached tensors it was given, with the host code that lands
them, in the registry's pending list (:meth:`MetricsRegistry.defer`), and
they land all at once at the next read the program already makes --
:func:`read` (the trainer's interval read, the serving loop's per-tick
read) copies them to the host in the same transfer as the program's own
values -- or at :meth:`MetricsRegistry.flush`, which ``snapshot``,
``to_prom`` and ``write_json`` call first.  The async serving pipeline,
which makes no read, takes them over (:meth:`MetricsRegistry.take_pending`),
copies them to pinned host memory with each entry's outputs and lands them
with the entry (:func:`land_host`).
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.parallel.sharding import whole

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "PromFlusher",
           "Series", "default_registry", "emit_scalar", "enabled",
           "land_host", "read",
           "record_backward", "record_prefix_lookup",
           "record_prefix_occupancy", "record_prefix_saved_iters",
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


class Series:
    """The most recent recorded sequence (one solve's residual tape) and
    how many sequences were recorded in all."""

    kind = "series"

    def __init__(self):
        self.last: list[float] = []
        self.count = 0

    def record(self, values) -> None:
        self.last = [float(v) for v in values]
        self.count += 1

    def payload(self) -> dict:
        return {"last": self.last, "count": self.count}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[tuple[str, _LabelsKey], object] = {}
        # (land, tensors): device values waiting for a host read
        self._pending: list[tuple[Callable, tuple[torch.Tensor, ...]]] = []

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

    def series(self, name: str, labels=None) -> Series:
        return self._get(Series, name, labels)

    # -- values on the device ----------------------------------------------

    def defer(self, land: Callable, *tensors: torch.Tensor) -> None:
        """Keep ``tensors`` (detached) until the next :meth:`read` or
        :meth:`flush`, which calls ``land(*arrays)`` with their values as
        numpy arrays of the same shapes."""
        with self._lock:
            self._pending.append((land, tuple(t.detach() for t in tensors)))

    def read(self, *tensors: torch.Tensor) -> list:
        """``tensors``' values as Python numbers or nested lists
        (``tolist()``), copied to the host in one transfer together with
        every pending value, which lands meanwhile."""
        with self._lock:
            pending, self._pending = self._pending, []
        parts = [t for _, ts in pending for t in ts] + [
            t.detach() for t in tensors]
        host = iter(_to_host(parts))
        for land, ts in pending:
            land(*[next(host).float().numpy() if t.is_floating_point()
                   else next(host).numpy() for t in ts])
        return [next(host).tolist() for _ in tensors]

    def flush(self) -> None:
        """Land every pending value (one transfer)."""
        self.read()

    def take_pending(self) -> list[tuple[Callable, tuple[torch.Tensor, ...]]]:
        """Hand the pending values over to a caller that copies them to the
        host without a wait and lands them itself (:func:`land_host`)."""
        with self._lock:
            pending, self._pending = self._pending, []
        return pending

    # -- export ------------------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._pending.clear()

    def snapshot(self) -> dict:
        self.flush()
        with self._lock:
            metrics = [
                {"name": name, "labels": dict(lk), "kind": m.kind,
                 **m.payload()}
                for (name, lk), m in sorted(self._metrics.items())
            ]
        return {"schema": "repro.obs.metrics/v1", "unix_time": time.time(),
                "pid": os.getpid(), "metrics": metrics}

    def write_json(self, path: str) -> dict:
        snap = self.snapshot()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(snap, fh, indent=1, sort_keys=True)
        return snap

    def to_prom(self, flush: bool = True) -> str:
        """The registry in the Prometheus text exposition format: counters
        and gauges one line each; histograms the cumulative
        ``_bucket{le=...}`` series (always with a ``+Inf`` bucket) plus
        ``_sum``/``_count``; a series, which Prometheus has no kind for, as
        its count of records (``<name>_records``, a gauge).  Names are
        sanitised to the Prometheus charset and label values escaped."""
        if flush:
            self.flush()
        with self._lock:
            items = sorted(self._metrics.items())
        groups: dict[str, list] = {}
        for (name, lk), m in items:
            groups.setdefault(name, []).append((lk, m))
        lines: list[str] = []
        for name, rows in groups.items():
            kind = rows[0][1].kind
            pname = _prom_name(name)
            if kind == "series":
                lines.append(f"# TYPE {pname}_records gauge")
                lines.extend(f"{pname}_records{_prom_labels(lk)} {m.count}"
                             for lk, m in rows if m.kind == kind)
                continue
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

    def write_prom(self, path: str, flush: bool = True) -> str:
        """Write :meth:`to_prom` atomically (a temporary file, then a
        rename), so a scrape of the file never sees a torn exposition."""
        text = self.to_prom(flush)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
        return text


def _to_host(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Host copies of ``parts``, each of its own shape and dtype; the ones
    on a card travel in one device-to-host copy (as float64, which holds
    every int32, bool, bf16 and f32 value exactly).  A value on a mesh (a
    DTensor) is taken whole, every rank reading the same."""
    parts = [whole(t) for t in parts]
    out = list(parts)
    dev = [i for i, t in enumerate(parts) if t.device.type != "cpu"]
    if dev:
        flat = torch.cat([parts[i].reshape(-1).to(torch.float64)
                          for i in dev]).cpu()
        at = 0
        for i in dev:
            n = parts[i].numel()
            out[i] = flat[at:at + n].reshape(parts[i].shape).to(
                parts[i].dtype)
            at += n
    return out


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
        # values still on the device land at the program's own reads: this
        # thread never reads the card
        while not self._stop.wait(self.interval_s):
            self.registry.write_prom(self.path, flush=False)

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
    """Switch the bridge on or off (off by default)."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def read(*tensors: torch.Tensor) -> list:
    """:meth:`MetricsRegistry.read` of the default registry: the program's
    own host read, which also lands what the bridge holds."""
    return _REGISTRY.read(*tensors)


def land_host(land: Callable, host: list[torch.Tensor]) -> None:
    """Land a pending value from :meth:`MetricsRegistry.take_pending` whose
    tensors are now host copies, as :meth:`MetricsRegistry.read` lands it."""
    land(*[t.float().numpy() if t.is_floating_point() else t.numpy()
           for t in host])


def snapshot() -> dict:
    """Snapshot of the default registry."""
    return _REGISTRY.snapshot()


def _land_scalar(name: str, labels, kind: str, v) -> None:
    v = float(np.asarray(v).reshape(-1)[0])
    if kind == "counter":
        _REGISTRY.counter(name, labels).inc(v)
    elif kind == "histogram":
        _REGISTRY.histogram(name, labels).observe(v)
    else:
        _REGISTRY.gauge(name, labels).set(v)


def emit_scalar(name: str, value, *, labels=None, kind: str = "gauge") -> None:
    """Land a scalar (a number or a one-element tensor) in the registry:
    ``kind`` "gauge" sets, "counter" adds, "histogram" observes.  A no-op
    when the bridge is off; a tensor lands at the next read."""
    if not _ENABLED:
        return
    frozen = dict(labels) if labels else None
    if isinstance(value, torch.Tensor):
        _REGISTRY.defer(lambda v: _land_scalar(name, frozen, kind, v), value)
    else:
        _land_scalar(name, frozen, kind, value)


def _mean_finite(x) -> float | None:
    x = np.asarray(x, np.float64).reshape(-1)
    x = x[np.isfinite(x)]
    return float(x.mean()) if x.size else None


def _land_solve(phase: str, n_steps: int, residual, warm=None, age=None,
                tape_res=None, status=None) -> None:
    """Host side of :func:`record_solve` (the reference's ``_solve_cb``)."""
    from repro_torch.core.solvers import STATUS_CONVERGED, STATUS_NAMES
    from repro_torch.obs.tape import tape_residual_series

    reg = _REGISTRY
    pl = {"phase": phase}
    reg.counter("solves_total", pl).inc()
    if status is not None:
        codes = np.asarray(status).reshape(-1)
        for code in np.unique(codes):
            if int(code) == STATUS_CONVERGED:
                continue
            reg.counter("solve_failures_total", {
                "phase": phase,
                "status": STATUS_NAMES.get(int(code), str(int(code))),
            }).inc(float((codes == code).sum()))
    w = None if warm is None else np.asarray(warm).reshape(-1).astype(bool)
    wl = "warm" if w is not None and w.size and w.mean() >= 0.5 else "cold"
    wpl = {"phase": phase, "warm": wl}
    reg.counter("solves_by_warm_total", wpl).inc()
    reg.counter("solve_iters_total", wpl).inc(n_steps)
    reg.gauge("solve_iters_last", wpl).set(n_steps)
    res = _mean_finite(residual)
    if res is not None:
        reg.histogram("solve_residual", pl).observe(res)
    if w is not None and age is not None and w.any():
        a = np.asarray(age, np.float64).reshape(-1)
        reg.histogram("carry_age_at_use", pl).observe(float(a[w].mean()))
    if tape_res is not None:
        series = tape_residual_series(tape_res)
        if series:
            reg.series("solve_residual_tape", pl).record(series)


def record_solve(phase: str, result, *, carry=None) -> None:
    """One solve's telemetry under ``{phase}``: ``result`` a
    ``SolveResult``/``ImplicitStats`` (``n_steps``, ``residual``, and the
    ``tape`` and ``status`` where it has them), ``carry`` the solve's entry
    carry (its ``warm``/``age`` classify a warm or cold start).  A no-op
    when the bridge is off."""
    if not _ENABLED:
        return
    parts, keys = [result.residual], []
    if carry is not None:
        parts += [carry.warm, carry.age]
        keys += ["warm", "age"]
    tape = getattr(result, "tape", None)
    if tape is not None:
        parts.append(tape.residual)
        keys.append("tape_res")
    status = getattr(result, "status", None)
    if status is not None:
        parts.append(status)
        keys.append("status")
    n = int(result.n_steps)
    _REGISTRY.defer(lambda res, *rest: _land_solve(
        phase, n, res, **dict(zip(keys, rest))), *parts)


def _land_backward(estimator: str, n_steps: int, residual,
                   fallback) -> None:
    reg = _REGISTRY
    pl = {"estimator": estimator}
    reg.counter("backward_estimates_total", pl).inc()
    reg.counter("backward_iters_total", pl).inc(n_steps)
    res = _mean_finite(residual)
    if res is not None:
        reg.histogram("backward_residual", pl).observe(res)
    fb = np.asarray(fallback)
    if fb.size:
        reg.counter("backward_fallbacks_total", pl).inc(float(fb.sum()))


def record_backward(estimator: str, adj) -> None:
    """One backward cotangent estimate (an ``AdjointResult``) under
    ``{estimator}``: estimates, iterations of its iterative part, mean
    finite residual and the samples whose fallback guard fired.  A no-op
    when the bridge is off."""
    if not _ENABLED:
        return
    n = int(adj.n_steps)
    _REGISTRY.defer(lambda res, fb: _land_backward(estimator, n, res, fb),
                    adj.residual, adj.fallback_mask)


# -- prefix carry cache (host-side: plain Python, unconditional) ------------


def record_prefix_lookup(outcome: str, *, matched_tokens: int = 0,
                         prompt_tokens: int = 0) -> None:
    """One prefix-cache admission lookup: ``outcome`` is ``hit`` (the whole
    prompt matched), ``partial`` (a shorter stored boundary) or ``miss``;
    the token totals give the hit coverage (matched / prompt tokens)."""
    reg = _REGISTRY
    reg.counter("prefix_cache_lookups_total", {"outcome": outcome}).inc()
    if matched_tokens:
        reg.counter("prefix_cache_matched_tokens_total").inc(
            float(matched_tokens))
    if prompt_tokens:
        reg.counter("prefix_cache_prompt_tokens_total").inc(
            float(prompt_tokens))


def record_prefix_occupancy(entries: int, tokens: int) -> None:
    """Mirror a prefix cache's occupancy into gauges."""
    reg = _REGISTRY
    reg.gauge("prefix_cache_entries").set(float(entries))
    reg.gauge("prefix_cache_tokens").set(float(tokens))


def record_prefix_saved_iters(saved) -> None:
    """Broyden iterations a seeded prefill saved against the cold
    reference, as the ``prefix_cache_saved_iters`` series."""
    _REGISTRY.series("prefix_cache_saved_iters").record(saved)
