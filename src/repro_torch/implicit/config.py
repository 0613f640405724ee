"""Configuration of the implicit (fixed-point) API.

The port of ``repro/implicit/config.py``: ``forward`` (which registered
solver finds ``z* = f(z*)`` and its budget), ``backward`` (the cotangent
estimator of the backward pass and its budget), and the shared qN
``memory`` and ring dtype.  All classes are frozen.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.solvers import SolverConfig


@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    """Forward (inner-problem) solve: find ``z* = f(z*)``."""

    solver: str = "broyden"   # any name registered in implicit SOLVERS
    max_steps: int = 24
    tol: float = 1e-4
    step_size: float = 1.0
    opa_freq: int = 0
    guard: bool = True
    divergence_ratio: float = 1e4
    stall_patience: int = 3
    stall_tol: float = -1.0
    restart_budget: int = 1
    restart_damping: float = 1.0


@dataclasses.dataclass(frozen=True)
class BackwardConfig:
    """Backward (adjoint) cotangent estimate (paper §2)."""

    estimator: str = "shine"
    max_steps: int = 30
    refine_steps: int = 5
    tol: float = 1e-6
    fallback_ratio: float = 1.3


@dataclasses.dataclass(frozen=True)
class ImplicitConfig:
    forward: ForwardConfig = dataclasses.field(default_factory=ForwardConfig)
    backward: BackwardConfig = dataclasses.field(
        default_factory=BackwardConfig)
    memory: int = 24
    unroll: bool = False
    qn_dtype: str = "bfloat16"

    def solver_cfg(self) -> SolverConfig:
        f = self.forward
        return SolverConfig(
            max_steps=f.max_steps, tol=f.tol, memory=self.memory,
            step_size=f.step_size, opa_freq=f.opa_freq, unroll=self.unroll,
            qn_dtype=self.qn_dtype,
            guard=f.guard, divergence_ratio=f.divergence_ratio,
            stall_patience=f.stall_patience, stall_tol=f.stall_tol,
            restart_budget=f.restart_budget,
            restart_damping=f.restart_damping,
        )

    def adjoint_cfg(self, steps: int) -> SolverConfig:
        """The refine/full adjoint solves: absolute tolerance, the forward
        guard knobs, the default step size and no OPA."""
        default = SolverConfig()
        return dataclasses.replace(
            self.solver_cfg(), max_steps=steps, tol=self.backward.tol,
            relative=False, step_size=default.step_size,
            opa_freq=default.opa_freq)

    @classmethod
    def from_strings(
        cls,
        *,
        solver: str = "broyden",
        backward: str = "shine",
        max_steps: int = 24,
        tol: float = 1e-4,
        memory: int = 24,
        step_size: float = 1.0,
        opa_freq: int = 0,
        backward_max_steps: int = 30,
        refine_steps: int = 5,
        backward_tol: float = 1e-6,
        fallback_ratio: float = 1.3,
        unroll: bool = False,
        qn_dtype: str = "bfloat16",
        guard: bool = True,
    ) -> "ImplicitConfig":
        """Build from the flat ``DEQSettings``-style field names."""
        return cls(
            forward=ForwardConfig(
                solver=solver, max_steps=max_steps, tol=tol,
                step_size=step_size, opa_freq=opa_freq, guard=guard,
            ),
            backward=BackwardConfig(
                estimator=backward, max_steps=backward_max_steps,
                refine_steps=refine_steps, tol=backward_tol,
                fallback_ratio=fallback_ratio,
            ),
            memory=memory,
            unroll=unroll,
            qn_dtype=qn_dtype,
        )
