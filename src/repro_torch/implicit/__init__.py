"""Implicit (fixed-point) API of the port: differentiable fixed points
(forward solves through the solver registry, backward through the
estimator registry), the batched serving engine, the per-slot carry
cache and the cross-request prefix caches."""

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
    CoalescedBatch,
    DevEntry,
    DevicePrefixStore,
    DevPrefixMatch,
    PrefixCarryIndex,
    PrefixEntry,
    PrefixMatch,
    batched_solve,
    coalesce_states,
    prefix_hashes,
    prefix_store_scatter,
    write_carry_rows,
    write_carry_slot,
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
    "AdjointResult", "BackwardConfig", "CarryCache", "CoalescedBatch",
    "DevEntry", "DevPrefixMatch", "DevicePrefixStore", "ESTIMATORS",
    "EstimatorContext", "ForwardConfig", "estimate_cotangent",
    "ImplicitConfig", "ImplicitStats", "PrefixCarryIndex", "PrefixEntry",
    "PrefixMatch", "Registry", "SOLVERS", "SolveCarry",
    "batched_solve", "coalesce_states", "implicit_fixed_point",
    "init_solve_carry", "prefix_hashes", "prefix_store_scatter",
    "register_estimator", "register_solver",
    "reset_carry_rows", "seed_carry", "write_carry_rows",
    "write_carry_slot",
]
