"""The training loop: restore or init, step, log, checkpoint, roll back.

The port of ``repro/runtime/trainer.py``.  The step function and the
``TrainState`` come from ``launch/steps.py``; this module owns the runtime
concerns: the step loop with one host read of the metrics per log
interval, the rollback past ``skip_budget`` consecutive rejected updates,
checkpointing, preemption and the straggler watchdog.  With tracing on,
each step is a ``data`` and a ``train_step`` span (a saved step adds a
``checkpoint`` span); the device phases marked inside ``train_step`` end
it no earlier than the card finishes them, without a host wait.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.implicit import ESTIMATORS, SOLVERS
from repro_torch.launch import steps
from repro_torch.launch.steps import TrainState
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.runtime.ft import PreemptionGuard, StragglerWatchdog

__all__ = ["Trainer", "TrainState"]


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 loss_fn: Callable | None = None, device=None,
                 params: dict | None = None):
        """``params`` (optional) are the initial parameters in place of a
        draw from ``tcfg.seed``; ``device`` places a drawn init (default
        the card)."""
        self.cfg, self.tcfg = cfg, tcfg
        if cfg.deq.enabled:
            # fail fast, with the registered options listed
            SOLVERS.get(cfg.deq.solver)
            ESTIMATORS.get(cfg.deq.backward)
        self.loss_fn = loss_fn
        if loss_fn is not None:
            # a custom loss cannot thread the solve carry: allocate none
            tcfg = dataclasses.replace(tcfg, deq_carry="off")
        self._tcfg_eff = tcfg
        self._device, self._params = device, params
        self._train_step = steps.build_train_step(cfg, tcfg, loss_fn=loss_fn)
        self.watchdog = StragglerWatchdog(n_hosts=1)
        self.ckpt = (
            CheckpointManager(
                tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints,
                # lean mode drops the (m, B, S, d) u/v carry ring; restore
                # zero-fills it (fill_missing_prefixes below), the identity
                # inverse
                omit_prefixes=((".carry.lowrank.u", ".carry.lowrank.v")
                               if tcfg.checkpoint_lean else ()))
            if tcfg.checkpoint_dir else None)

    # ------------------------------------------------------------------

    def init_state(self, seed: int | None = None) -> TrainState:
        return steps.init_train_state(self.cfg, self._tcfg_eff, seed=seed,
                                      params=self._params,
                                      device=self._device)

    def restore_or_init(self) -> TrainState:
        return self._restore_or_init()[0]

    def _restore_or_init(self) -> tuple[TrainState, int]:
        """The state and its step, known on the host (no read of the
        card)."""
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            # the carry and the skip count are forward-compatible state:
            # zero-filled they are a cold carry and "no skips"
            step, state, _ = self.ckpt.restore(
                self.init_state(),
                fill_missing_prefixes=(".carry", ".skips"))
            return state, int(step)
        return self.init_state(), 0

    def _rollback(self, at_step: int) -> TrainState:
        """Every recent update was rejected: restore the last checkpoint (or
        re-init without one), loudly, with a fresh skip budget."""
        obs_metrics.default_registry().counter("train_rollbacks_total").inc()
        budget = self.tcfg.skip_budget
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            fresh = self.restore_or_init()
            print(f"step {at_step}: {budget}+ consecutive non-finite updates "
                  f"-- rolled back to checkpoint step {int(fresh.step)}")
        else:
            fresh = self.init_state()
            print(f"step {at_step}: {budget}+ consecutive non-finite updates "
                  f"and no checkpoint -- re-initialized from scratch")
        if fresh.skips is not None:
            fresh = fresh._replace(skips=torch.zeros_like(fresh.skips))
        return fresh

    def run(self, batches: Iterator[dict], *, steps: int | None = None,
            log_every: int = 10,
            on_metrics: Callable[[int, dict], None] | None = None
            ) -> TrainState:
        state, start = self._restore_or_init()
        steps = steps if steps is not None else self.tcfg.steps
        t_sync = time.perf_counter()
        n_since = 0
        skipped = None  # rejected updates since the last read, on the device
        with PreemptionGuard() as guard:
            for i in range(start, steps):
                with obs_tracing.span("data", step=i + 1):
                    batch = next(batches)
                with obs_tracing.span("train_step", step=i + 1):
                    state, metrics = self._train_step(state, batch)
                if "update_skipped" in metrics:
                    skipped = (metrics["update_skipped"] if skipped is None
                               else skipped + metrics["update_skipped"])
                n_since += 1
                if (i + 1) % log_every == 0 or i + 1 == steps:
                    # the interval's one host read: every metric on the
                    # device at once, the interval's count of rejected
                    # updates, and what the metrics bridge holds
                    names = [k for k, v in metrics.items()
                             if isinstance(v, torch.Tensor)]
                    vals = obs_metrics.read(
                        *[metrics[k] for k in names],
                        *([skipped] if skipped is not None else []))
                    if skipped is not None:
                        obs_metrics.emit_scalar("train_update_skips_total",
                                                vals.pop(), kind="counter")
                        skipped = None
                    metrics = {k: float(v) for k, v in
                               {**metrics, **dict(zip(names, vals))}.items()}
                    now = time.perf_counter()
                    # the read drains every step since the last one, so the
                    # honest per-step time is the interval average
                    dt = (now - t_sync) / max(n_since, 1)
                    t_sync, n_since = now, 0
                    self.watchdog.record(0, dt)
                    self.watchdog.publish_metrics()
                    if (self.tcfg.skip_nonfinite
                            and metrics.get("consec_skips", 0.0)
                            >= self.tcfg.skip_budget):
                        state = self._rollback(i + 1)
                    if on_metrics:
                        on_metrics(i + 1, metrics)
                    else:
                        print(f"step {i + 1:5d} loss={metrics['loss']:.4f} "
                              f"gnorm={metrics['grad_norm']:.3f} "
                              f"lr={metrics['lr']:.2e} {dt * 1e3:.0f}ms")
                if self.ckpt and self.tcfg.checkpoint_every and (
                        (i + 1) % self.tcfg.checkpoint_every == 0):
                    with obs_tracing.span("checkpoint", step=i + 1):
                        self.ckpt.save(i + 1, state)
                    # keep checkpoint time out of the per-step average
                    t_sync, n_since = time.perf_counter(), 0
                if guard.should_exit:
                    if self.ckpt:
                        self.ckpt.save(i + 1, state)
                        self.ckpt.wait()
                    print(f"preempted at step {i + 1}; state saved; "
                          f"exiting 0")
                    break
        if self.ckpt:
            self.ckpt.wait()
        return state
