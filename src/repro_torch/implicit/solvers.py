"""Registered forward fixed-point solvers.

The port of ``repro/implicit/solvers.py``: adapters from the registry's
uniform signature

    solver(f, z0, cfg, *, outer_grad=None, freeze_mask=None, carry=None)
        -> SolveResult

(``f(z) -> z`` the fixed-point map) onto ``core.solvers``.  The root
solvers (``broyden``, ``adjoint_broyden``) want the residual ``g(z) = z -
f(z)``; ``fixed_point`` and ``anderson`` take ``f`` itself.  Only
``adjoint_broyden`` reads ``outer_grad`` (its OPA updates).
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch

from repro_torch.core.solvers import (
    SolveResult,
    SolverConfig,
    adjoint_broyden_solve,
    anderson_solve,
    broyden_solve,
    fixed_point_solve,
)
from repro_torch.implicit.registry import register_solver

FixedPointMap = Callable[[torch.Tensor], torch.Tensor]


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
def _broyden(f: FixedPointMap, z0: torch.Tensor, cfg: SolverConfig, *,
             outer_grad=None, freeze_mask=None, carry=None) -> SolveResult:
    return broyden_solve(lambda z: z - f(z), z0, cfg,
                         freeze_mask=freeze_mask, carry=carry)


@register_solver("adjoint_broyden")
def _adjoint_broyden(f: FixedPointMap, z0: torch.Tensor, cfg: SolverConfig,
                     *, outer_grad=None, freeze_mask=None,
                     carry=None) -> SolveResult:
    return adjoint_broyden_solve(lambda z: z - f(z), z0, cfg,
                                 outer_grad=outer_grad,
                                 freeze_mask=freeze_mask, carry=carry)


@register_solver("fixed_point")
def _fixed_point(f: FixedPointMap, z0: torch.Tensor, cfg: SolverConfig, *,
                 outer_grad=None, freeze_mask=None,
                 carry=None) -> SolveResult:
    return fixed_point_solve(f, z0, cfg, freeze_mask=freeze_mask,
                             carry=carry)


@register_solver("anderson")
def _anderson(f: FixedPointMap, z0: torch.Tensor, cfg: SolverConfig, *,
              outer_grad=None, freeze_mask=None, carry=None) -> SolveResult:
    return anderson_solve(f, z0, cfg, freeze_mask=freeze_mask, carry=carry)
