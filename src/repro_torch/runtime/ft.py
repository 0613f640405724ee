"""Fault-tolerance helpers of the training loop: preemption, stragglers and
elastic re-meshing.

The port of ``repro/runtime/ft.py``:

  * ``PreemptionGuard`` -- SIGTERM/SIGINT flip a flag the training loop
    polls; the loop checkpoints and exits 0.
  * ``StragglerWatchdog`` -- per-host step-time EMA with robust z-score
    outlier flagging, mirrored onto the metrics registry;
  * ``ElasticMeshManager`` -- after a node loss, the (data, model) shape
    of the largest power-of-two DP over the ranks left, keeping the TP
    degree where it divides, and the ``DeviceMesh`` over the first of them
    (the rest are hot standbys).
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


class ElasticMeshManager:
    """Re-mesh after node loss; prefers keeping the TP degree intact
    (changing TP invalidates microbatch math less gracefully than
    shrinking DP)."""

    def __init__(self, model_parallel: int):
        self.tp = model_parallel

    def choose_shape(self, n_devices: int) -> tuple[int, int]:
        tp = self.tp
        while tp > 1 and (n_devices < tp or n_devices % tp):
            tp //= 2
        dp = n_devices // tp
        # the largest power-of-two DP (an uneven remainder is dropped: the
        # spares become hot standbys)
        p = 1
        while p * 2 <= dp:
            p *= 2
        return (p, tp)

    def build(self, n_ranks: int | None = None, device_type: str = "cuda"):
        """``(MeshSpec, DeviceMesh)`` of ``choose_shape(n_ranks)`` (default
        the world) over ranks ``0 .. p * tp - 1``, axes ("data", "model").
        Every rank of the world calls it (the groups are made
        collectively); a standby rank gets ``(spec, None)``."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.launch.mesh import MeshSpec

        world = dist.get_world_size()
        shape = self.choose_shape(world if n_ranks is None else n_ranks)
        spec = MeshSpec(("data", "model"), shape)
        ranks = torch.arange(shape[0] * shape[1]).reshape(shape)
        mesh = DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))
        return spec, (mesh if dist.get_rank() < ranks.numel() else None)
