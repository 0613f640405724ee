"""Registered forward fixed-point solvers.

The port of ``repro/implicit/solvers.py`` for the Broyden solver: an
adapter from the registry's uniform signature

    solver(f, z0, cfg, *, outer_grad=None, freeze_mask=None, carry=None)
        -> SolveResult

(``f(z) -> z`` the fixed-point map) onto ``core.solvers.broyden_solve``,
which wants the residual ``g(z) = z - f(z)``.
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

from repro_torch.core.solvers import SolveResult, SolverConfig, broyden_solve
from repro_torch.implicit.registry import register_solver


def call_solver(solver, f, z0, cfg, *, outer_grad=None, freeze_mask=None,
                carry=None):
    """Invoke a registered solver.  ``freeze_mask`` and ``carry`` change
    semantics, so they are forwarded only to solvers that name them, and a
    solver that does not name one that was given raises."""
    kw = {"outer_grad": outer_grad, "freeze_mask": freeze_mask,
          "carry": carry}
    params = inspect.signature(solver).parameters
    var_kw = any(p.kind is p.VAR_KEYWORD for p in params.values())
    for name in ("freeze_mask", "carry"):
        if name not in params:
            if kw[name] is not None:
                raise TypeError(f"solver {solver!r} does not declare {name}")
            del kw[name]
    if not var_kw:
        for name in list(kw):
            if name not in params:
                del kw[name]
    return solver(f, z0, cfg, **kw)


@register_solver("broyden")
def _broyden(f: Callable[[torch.Tensor], torch.Tensor], z0: torch.Tensor,
             cfg: SolverConfig, *, outer_grad=None, freeze_mask=None,
             carry=None) -> SolveResult:
    return broyden_solve(lambda z: z - f(z), z0, cfg,
                         freeze_mask=freeze_mask, carry=carry)
