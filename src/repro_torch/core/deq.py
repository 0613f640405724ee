"""The legacy DEQ entry point: a shim over ``repro_torch.implicit``.

The port of ``repro/core/deq.py``.  ``deq_fixed_point(f, params, x, z0,
cfg)`` computes ``z* = f(params, x, z*)`` with a quasi-Newton solver and a
SHINE-family implicit backward; ``DEQConfig`` is the old flat string-keyed
config (``to_implicit()`` converts it) and ``pack_state`` the old
multiscale flattening helper, now in ``implicit/pytree.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.implicit import (
    ImplicitConfig,
    ImplicitStats,
    implicit_fixed_point,
    pack_state,  # noqa: F401  (re-export)
)

DEQStats = ImplicitStats


@dataclasses.dataclass(frozen=True)
class DEQConfig:
    """Legacy flat config; prefer ``repro_torch.implicit.ImplicitConfig``."""

    # ---- forward (inner problem) ----
    solver: str = "broyden"      # any name in repro_torch.implicit.SOLVERS
    max_steps: int = 24
    tol: float = 1e-4
    memory: int = 24
    step_size: float = 1.0
    # adjoint-Broyden OPA extra updates every M steps (0 = off); needs an
    # outer_grad passed to deq_fixed_point
    opa_freq: int = 0
    # ---- backward (hypergradient) ----
    backward: str = "shine"      # any name in repro_torch.implicit.ESTIMATORS
    backward_max_steps: int = 30
    refine_steps: int = 5
    backward_tol: float = 1e-6
    fallback_ratio: float = 1.3
    unroll: bool = False

    def to_implicit(self) -> ImplicitConfig:
        return ImplicitConfig.from_strings(
            solver=self.solver, backward=self.backward,
            max_steps=self.max_steps, tol=self.tol, memory=self.memory,
            step_size=self.step_size, opa_freq=self.opa_freq,
            backward_max_steps=self.backward_max_steps,
            refine_steps=self.refine_steps, backward_tol=self.backward_tol,
            fallback_ratio=self.fallback_ratio, unroll=self.unroll,
        )


def as_implicit_config(cfg: DEQConfig | ImplicitConfig) -> ImplicitConfig:
    """Normalise either config flavour to ``ImplicitConfig``."""
    if isinstance(cfg, ImplicitConfig):
        return cfg
    return cfg.to_implicit()


def deq_fixed_point(
    f: Callable[[Any, Any, torch.Tensor], torch.Tensor],
    params: Any,
    x: Any,
    z0,
    cfg: DEQConfig | ImplicitConfig,
    *,
    outer_grad: Callable[[Any, Any, torch.Tensor], torch.Tensor] | None = None,
):
    """Differentiable fixed point of ``z = f(params, x, z)``;
    ``outer_grad(params, x, z) -> dL/dz`` enables OPA in the adjoint-Broyden
    forward (paper §2.3)."""
    return implicit_fixed_point(f, params, x, z0, as_implicit_config(cfg),
                                outer_grad=outer_grad)
