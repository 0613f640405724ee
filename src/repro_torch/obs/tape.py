"""Solver convergence tape: fixed-size per-iteration telemetry buffers.

The port of ``repro/obs/tape.py``.  A :class:`SolveTape` rides the solver
loop and records, per iteration and per sample, the post-step residual
norm (inf where unrecorded), the step length (0 where unrecorded), the
quasi-Newton ring occupancy and, for guarded solvers, the health code (-1
where unrecorded).  Frozen samples keep their cells bit for bit.
:func:`tape_residual_series` digests a tape's residuals on the host (the
metrics bridge's ``solve_residual_tape`` series), :func:`tape_summary` a
whole tape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SolveTape(NamedTuple):
    residual: torch.Tensor   # f32, inf-padded
    step_norm: torch.Tensor  # f32, 0-padded
    qn_count: torch.Tensor   # int32, 0-padded
    status: torch.Tensor | None = None  # int32, -1 = unrecorded


def empty_tape(max_steps: int, batch: int | None,
               device: torch.device | str = "cpu") -> SolveTape:
    """An all-unrecorded tape (``batch=None`` for the scalar L-BFGS
    form)."""
    shape = (max(max_steps, 1),) if batch is None \
        else (max(max_steps, 1), batch)
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


def tape_residual_series(residual) -> list[float]:
    """Host side: the batch-mean residual of each realized iteration
    (finite entries only), up to the last iteration any sample recorded."""
    r = np.asarray(residual, np.float64)
    if r.ndim == 1:
        r = r[:, None]
    finite = np.isfinite(r)
    realized = finite.any(axis=1)
    if not realized.any():
        return []
    last = int(np.nonzero(realized)[0].max()) + 1
    out = []
    for k in range(last):
        row = r[k][finite[k]]
        out.append(float(row.mean()) if row.size else float("nan"))
    return out


def tape_summary(tape: SolveTape) -> dict:
    """Host-side digest of one solve's tape (JSON-able): a read of the
    device for each of its buffers."""
    series = tape_residual_series(tape.residual.cpu())
    qn = tape.qn_count.cpu().numpy()
    step = tape.step_norm.cpu().numpy().astype(np.float64)
    return {
        "n_iters": len(series),
        "residual_series": series,
        "final_residual": series[-1] if series else None,
        "qn_occupancy_max": int(qn.max()) if qn.size else 0,
        "step_norm_max": float(step.max()) if step.size else 0.0,
    }
