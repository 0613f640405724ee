"""Observability of the port: metrics registry, solver convergence tapes
and span tracing (``repro/obs``'s three pillars, each usable alone).

  * :mod:`repro_torch.obs.metrics` -- counters, gauges, histograms and
    series with labels, JSON snapshots, Prometheus text, and the bridge
    that keeps a solve's device values and lands them at the program's own
    reads.
  * :mod:`repro_torch.obs.tape` -- the per-iteration :class:`SolveTape`
    every solver fills.
  * :mod:`repro_torch.obs.tracing` -- timed spans written as Chrome-trace
    JSON, with ``phase_done`` marks inside a step.

Both switches are off by default: the bridge then records nothing and the
tracer opens no span.
"""

from __future__ import annotations

from repro_torch.obs import metrics, tape, tracing
from repro_torch.obs.metrics import (
    MetricsRegistry,
    default_registry,
    emit_scalar,
    record_backward,
    record_solve,
)
from repro_torch.obs.tape import (
    SolveTape,
    empty_tape,
    tape_record,
    tape_summary,
)
from repro_torch.obs.tracing import (
    TraceRecorder,
    default_recorder,
    phase_done,
    span,
)

__all__ = [
    "metrics", "tape", "tracing",
    "MetricsRegistry", "default_registry", "emit_scalar",
    "record_solve", "record_backward",
    "SolveTape", "empty_tape", "tape_record", "tape_summary",
    "TraceRecorder", "default_recorder", "span", "phase_done",
    "enable", "disable", "status",
]


def enable(*, metrics_on: bool = True, tracing_on: bool = True) -> None:
    """Switch the metrics bridge and/or the span tracer on."""
    if metrics_on:
        metrics.set_enabled(True)
    if tracing_on:
        tracing.set_enabled(True)


def disable() -> None:
    metrics.set_enabled(False)
    tracing.set_enabled(False)


def status() -> dict:
    return {"metrics": metrics.enabled(), "tracing": tracing.enabled()}
