"""Implicit (fixed-point) API of the port: differentiable fixed points
(forward solves through the solver registry, backward through the
estimator registry), the batched serving engine and the per-slot carry
cache."""

from repro_torch.core.solvers import (
    SolveCarry,
    init_solve_carry,
    reset_carry_rows,
    seed_carry,
)
from repro_torch.implicit.config import (
    BackwardConfig,
    ForwardConfig,
    ImplicitConfig,
)
from repro_torch.implicit.estimators import (
    AdjointResult,
    EstimatorContext,
    estimate_cotangent,
)
from repro_torch.implicit.engine import (
    CarryCache,
    batched_solve,
    write_carry_rows,
)
from repro_torch.implicit.fixed_point import (
    ImplicitStats,
    implicit_fixed_point,
)
from repro_torch.implicit.registry import (
    ESTIMATORS,
    SOLVERS,
    Registry,
    register_estimator,
    register_solver,
)

__all__ = [
    "AdjointResult", "BackwardConfig", "CarryCache", "ESTIMATORS",
    "EstimatorContext", "ForwardConfig", "estimate_cotangent",
    "ImplicitConfig", "ImplicitStats", "Registry", "SOLVERS", "SolveCarry",
    "batched_solve", "implicit_fixed_point",
    "init_solve_carry", "register_estimator", "register_solver",
    "reset_carry_rows", "seed_carry", "write_carry_rows",
]
