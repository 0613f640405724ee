"""Solver convergence tape: fixed-size per-iteration telemetry buffers.

The port of ``repro/obs/tape.py``.  A :class:`SolveTape` rides the solver
loop and records, per iteration and per sample, the post-step residual
norm (inf where unrecorded), the step length (0 where unrecorded), the
quasi-Newton ring occupancy and, for guarded solvers, the health code (-1
where unrecorded).  Frozen samples keep their cells bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SolveTape(NamedTuple):
    residual: torch.Tensor   # f32, inf-padded
    step_norm: torch.Tensor  # f32, 0-padded
    qn_count: torch.Tensor   # int32, 0-padded
    status: torch.Tensor | None = None  # int32, -1 = unrecorded


def empty_tape(max_steps: int, batch: int,
               device: torch.device | str = "cpu") -> SolveTape:
    shape = (max(max_steps, 1), batch)
    return SolveTape(
        residual=torch.full(shape, float("inf"), dtype=torch.float32,
                            device=device),
        step_norm=torch.zeros(shape, dtype=torch.float32, device=device),
        qn_count=torch.zeros(shape, dtype=torch.int32, device=device),
        status=torch.full(shape, -1, dtype=torch.int32, device=device),
    )


def tape_record(tape: SolveTape, k: int, active: torch.Tensor,
                residual: torch.Tensor, step_norm: torch.Tensor,
                qn_count: torch.Tensor,
                status: torch.Tensor | None = None) -> SolveTape:
    """Record iteration ``k`` for samples where ``active`` (in place: the
    tape's buffers belong to the running solve)."""
    tape.residual[k] = torch.where(active, residual, tape.residual[k])
    tape.step_norm[k] = torch.where(active, step_norm.float(),
                                    tape.step_norm[k])
    tape.qn_count[k] = torch.where(active, qn_count.int(), tape.qn_count[k])
    if status is not None and tape.status is not None:
        tape.status[k] = torch.where(active, status.int(), tape.status[k])
    return tape
