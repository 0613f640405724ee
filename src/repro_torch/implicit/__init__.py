"""Implicit (fixed-point) API of the port: differentiable fixed points
(forward solves through the solver registry, backward through the
estimator registry), the batched serving engine, the per-slot carry
cache and the cross-request prefix caches."""

from repro_torch.core.solvers import (
    SolveCarry,
    carry_state_only,
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
    adjoint_system,
    bilevel_context,
    deq_context,
    estimate_cotangent,
    estimate_hypergrad_cotangent,
    fallback_cotangent,
    jfb_cotangent,
    shine_cotangent,
    shine_cotangent_multi,
    solve_adjoint,
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
    SolveLayout,
    carry_for_state,
    implicit_fixed_point,
)
from repro_torch.implicit.pytree import pack_state, ravel_state
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
    "EstimatorContext", "ForwardConfig", "ImplicitConfig", "ImplicitStats",
    "PrefixCarryIndex", "PrefixEntry", "PrefixMatch", "Registry", "SOLVERS",
    "SolveCarry", "SolveLayout", "adjoint_system", "batched_solve",
    "bilevel_context", "carry_for_state", "carry_state_only",
    "coalesce_states", "deq_context", "estimate_cotangent",
    "estimate_hypergrad_cotangent", "fallback_cotangent",
    "implicit_fixed_point", "init_solve_carry", "jfb_cotangent",
    "pack_state", "prefix_hashes", "prefix_store_scatter", "ravel_state",
    "register_estimator", "register_solver", "reset_carry_rows",
    "seed_carry", "shine_cotangent", "shine_cotangent_multi",
    "solve_adjoint", "write_carry_rows", "write_carry_slot",
]
