"""The fixed point ``z* = f(params, x, z*)``: forward solve.

The port of the forward half of ``repro/implicit/fixed_point.py``: the
registered solver runs under ``torch.no_grad()`` and returns the best
iterate with its :class:`ImplicitStats`.  The backward (the SHINE-family
cotangent estimators, reusing the forward's quasi-Newton inverse) comes with
the training slice; until then a call with any input that requires grad
raises instead of silently returning a gradient-free result.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

# populate the registry with the built-in solvers on import
from repro_torch.implicit import solvers as _builtin_solvers
from repro_torch.core.solvers import SolveCarry
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.pytree import prepare_flat_problem
from repro_torch.implicit.registry import SOLVERS
from repro_torch.obs.tape import SolveTape


class ImplicitStats(NamedTuple):
    residual: torch.Tensor    # (B,) forward residual at z*
    n_steps: int              # forward iterations
    converged: torch.Tensor   # (B,)
    trace: torch.Tensor       # (max_steps, B)
    tape: SolveTape | None = None
    status: torch.Tensor | None = None  # (B,) STATUS_* codes


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _require_no_grad(*trees) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for tree in trees for t in _tensors(tree)):
        raise NotImplementedError(
            "implicit_fixed_point: the backward (SHINE cotangent "
            "estimators) is not ported yet; call under torch.no_grad() or "
            "with tensors that do not require grad")


def solve_forward(f_z, z0, cfg: ImplicitConfig, *, freeze_mask=None,
                  carry=None):
    solver = SOLVERS.get(cfg.forward.solver)
    return _builtin_solvers.call_solver(
        solver, f_z, z0, cfg.solver_cfg(), freeze_mask=freeze_mask,
        carry=carry)


def implicit_fixed_point(
    f: Callable[[Any, Any, torch.Tensor], torch.Tensor],
    params: Any,
    x: Any,
    z0: torch.Tensor,
    cfg: ImplicitConfig,
    *,
    carry: SolveCarry | None = None,
):
    """Fixed point of ``z = f(params, x, z)``.  Returns ``(z*, stats)``, or
    ``(z*, stats, new_carry)`` when ``carry`` is given."""
    _require_no_grad(params, x, z0)
    z0_flat, unravel, f_flat = prepare_flat_problem(f, z0)
    with torch.no_grad():
        res = solve_forward(lambda z: f_flat(params, x, z), z0_flat, cfg,
                            carry=carry)
    stats = ImplicitStats(res.residual, res.n_steps, res.converged,
                          res.trace, res.tape, res.status)
    if carry is None:
        return unravel(res.z), stats
    return unravel(res.z), stats, res.carry
