"""Fault-tolerance helpers of the training loop: preemption and stragglers.

The port of ``PreemptionGuard`` and ``StragglerWatchdog`` from
``repro/runtime/ft.py`` (elastic re-meshing comes with the layout slice):

  * ``PreemptionGuard`` -- SIGTERM/SIGINT flip a flag the training loop
    polls; the loop checkpoints and exits 0.
  * ``StragglerWatchdog`` -- per-host step-time EMA with robust z-score
    outlier flagging, mirrored onto the metrics registry.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics


class PreemptionGuard:
    def __init__(self,
                 signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT)):
        self._flag = False
        self._old = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_exit(self) -> bool:
        return self._flag


@dataclasses.dataclass
class StragglerReport:
    host: int
    step_time: float
    zscore: float


class StragglerWatchdog:
    """Flags hosts whose step time deviates persistently from the fleet."""

    def __init__(self, n_hosts: int, *, ema: float = 0.9,
                 threshold: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.n_hosts = n_hosts
        self.ema = ema
        self.threshold = threshold
        self.clock = clock
        self._avg = np.zeros(n_hosts)
        self._initialized = np.zeros(n_hosts, bool)
        self._flagged: set[int] = set()

    def record(self, host: int, step_time: float) -> None:
        if not self._initialized[host]:
            self._avg[host] = step_time
            self._initialized[host] = True
        else:
            self._avg[host] = (self.ema * self._avg[host]
                               + (1 - self.ema) * step_time)

    def _zscores(self) -> dict[int, float]:
        """Robust (median/MAD) per-host z-score of the step-time EMA."""
        if self._initialized.sum() < 2:
            return {}
        avgs = self._avg[self._initialized]
        med = np.median(avgs)
        mad = np.median(np.abs(avgs - med)) + 1e-9
        return {h: float(0.6745 * (self._avg[h] - med) / mad)
                for h in range(self.n_hosts) if self._initialized[h]}

    def stragglers(self) -> list[StragglerReport]:
        return [StragglerReport(h, float(self._avg[h]), z)
                for h, z in self._zscores().items() if z > self.threshold]

    def publish_metrics(self) -> list[StragglerReport]:
        """A per-host ``straggler_zscore`` gauge, and
        ``stragglers_flagged_total`` counted when a host newly crosses the
        threshold."""
        reg = obs_metrics.default_registry()
        out = []
        for h, z in self._zscores().items():
            reg.gauge("straggler_zscore", {"host": str(h)}).set(z)
            if z > self.threshold:
                out.append(StragglerReport(h, float(self._avg[h]), z))
                if h not in self._flagged:
                    self._flagged.add(h)
                    reg.counter("stragglers_flagged_total").inc()
            else:
                self._flagged.discard(h)
        return out
