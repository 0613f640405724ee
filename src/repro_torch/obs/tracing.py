"""Span tracing: timed spans emitting Chrome-trace JSON.

The port of ``repro/obs/tracing.py``.  The recorder collects events in the
Trace Event Format that Perfetto and chrome://tracing read:
``{"traceEvents": [...]}`` with ``B``/``E`` span pairs for host phases and
complete ``X`` events for phases whose end is observed on the device.

Two ways to mark time:

  * :func:`span`, a host context manager (``with span("train_step",
    step=i): ...``) emitting a B/E pair.  Nest freely.

  * :func:`phase_done`, called where a phase has been issued, with tensors
    it produces.  On the CPU the values are ready when the call returns,
    so the phase ends then.  For CUDA tensors it records a CUDA event on
    the current stream and returns at once: the event's device time is
    resolved onto the host clock when the trace is read (:func:`write`),
    so the path gains no host synchronisation.  The ``X`` event spans from
    the previous phase boundary (the enclosing span's start, or the last
    phase end) to the phase's end, so within one span the phases tile it
    (``forward_solve``, ``implicit_backward``, ``optimizer``).  A span
    inside which device phases were marked ends no earlier than the last
    of them, so they nest in it.

All events share one pid and one synthetic tid, so nesting is decided by
time containment alone.  With tracing off (the default) :func:`span`,
:func:`instant` and :func:`phase_done` record nothing and cost a flag test.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

import torch

__all__ = ["TraceRecorder", "default_recorder", "set_enabled", "enabled",
           "span", "instant", "phase_done", "write", "clear"]

_PID = os.getpid()
_TID = 1


class _DeviceMark:
    """A point on a card's timeline: a timing event recorded on the
    current stream of ``device``, read at resolution."""

    __slots__ = ("device", "event")

    def __init__(self, device: torch.device):
        self.device = device
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record(torch.cuda.current_stream(device))


class _Latest:
    """The later of a host time and a device mark (a span's end)."""

    __slots__ = ("host", "mark")

    def __init__(self, host: float, mark: _DeviceMark):
        self.host, self.mark = host, mark


class TraceRecorder:
    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._t0 = time.perf_counter()
        # the last phase boundary (host µs, a _DeviceMark or a _Latest):
        # the start of the innermost open span, or the end of the latest
        # phase or span; phase_done events span from here to their end
        self._anchor = None
        self._last_mark: _DeviceMark | None = None

    def _now(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6  # µs

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    # -- host spans --------------------------------------------------------

    @contextmanager
    def span(self, name: str, **args):
        t = self._now()
        self._append({"name": name, "ph": "B", "ts": t, "pid": _PID,
                      "tid": _TID, **({"args": args} if args else {})})
        prev_anchor, self._anchor = self._anchor, t
        mark_before = self._last_mark
        try:
            yield
        finally:
            t1 = self._now()
            if self._last_mark is not mark_before:
                # device phases marked inside: end no earlier than the last
                t1 = _Latest(t1, self._last_mark)
            self._append({"name": name, "ph": "E", "ts": t1, "pid": _PID,
                          "tid": _TID})
            # phases after this span anchor at its end, not inside it
            self._anchor = t1 if prev_anchor is not None else None

    def instant(self, name: str, **args) -> None:
        self._append({"name": name, "ph": "i", "s": "t", "ts": self._now(),
                      "pid": _PID, "tid": _TID,
                      **({"args": args} if args else {})})

    def phase_done(self, name: str, device: torch.device | None = None,
                   **args) -> None:
        """Record a complete X event from the previous phase boundary to
        now (``device=None``) or to when the work issued so far on
        ``device``'s current stream completes."""
        if device is None:
            end = self._now()
        else:
            end = self._last_mark = _DeviceMark(device)
        start = self._anchor if self._anchor is not None else end
        self._append({"name": name, "ph": "X", "ts": start, "_end": end,
                      "pid": _PID, "tid": _TID,
                      **({"args": args} if args else {})})
        self._anchor = end

    # -- export ------------------------------------------------------------

    def _resolve(self) -> None:
        """Put every device mark on the host clock.  Each card is
        synchronised once and a calibration event taken: a mark's host time
        is the calibration's minus the device time between them."""
        with self._lock:
            pending = [e for e in self._events
                       if "_end" in e or not isinstance(e["ts"], float)]
        if not pending:
            return
        marks = [m for e in pending for m in (e["ts"], e.get("_end"))
                 if m is not None and not isinstance(m, float)]
        cal = {}
        for dev in {(m.mark if isinstance(m, _Latest) else m).device
                    for m in marks}:
            torch.cuda.synchronize(dev)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
            cal[dev] = (ev, self._now())

        def host(m) -> float:
            if isinstance(m, float):
                return m
            if isinstance(m, _Latest):
                return max(m.host, host(m.mark))
            ev, t_cal = cal[m.device]
            return max(t_cal - m.event.elapsed_time(ev) * 1e3, 0.0)

        with self._lock:
            for e in pending:
                e["ts"] = host(e["ts"])
                if "_end" in e:
                    # unclamped: a phase that ended before it began is a
                    # fault to see, not to round away
                    e["dur"] = host(e.pop("_end")) - e["ts"]

    def events(self) -> list[dict]:
        self._resolve()
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": _TID,
                 "args": {"name": "repro_torch"}},
                {"name": "thread_name", "ph": "M", "pid": _PID, "tid": _TID,
                 "args": {"name": "steps"}}]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> dict:
        trace = self.to_chrome_trace()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(trace, fh, indent=1)
        return trace

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
        self._anchor = self._last_mark = None


_RECORDER = TraceRecorder()
_ENABLED = False


def default_recorder() -> TraceRecorder:
    return _RECORDER


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


@contextmanager
def span(name: str, **args):
    """Host timed span on the default recorder; no-op when disabled."""
    if not _ENABLED:
        yield
        return
    with _RECORDER.span(name, **args):
        yield


def instant(name: str, **args) -> None:
    if _ENABLED:
        _RECORDER.instant(name, **args)


def phase_done(name: str, *deps, **args) -> None:
    """Close phase ``name``, which produced the tensors ``deps``: now for
    CPU tensors (or none), when the card has computed them for CUDA
    tensors.  No-op when tracing is disabled."""
    if not _ENABLED:
        return
    dev = next((d.device for d in deps
                if isinstance(d, torch.Tensor) and d.is_cuda), None)
    _RECORDER.phase_done(name, dev, **args)


def write(path: str) -> dict:
    return _RECORDER.write(path)


def clear() -> None:
    _RECORDER.clear()
