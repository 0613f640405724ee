"""The legacy backward-mode surface: a shim over ``repro_torch.implicit``.

The port of ``repro/core/hypergrad.py``.  The cotangent estimators (paper
§2: full / shine / jfb / fallback / refine-k) live in
``implicit/estimators.py`` behind the estimator registry; this module
re-exports the primitive operations and keeps the flat
``BackwardConfig``/``estimate_cotangent`` signature.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.lowrank import LowRank
from repro_torch.implicit import (  # noqa: F401  (re-exports)
    AdjointResult,
    adjoint_system,
    fallback_cotangent,
    jfb_cotangent,
    shine_cotangent,
    solve_adjoint,
)
from repro_torch.implicit import estimators as _estimators
from repro_torch.implicit.config import BackwardConfig as _NewBackwardConfig
from repro_torch.implicit.config import ForwardConfig as _ForwardConfig
from repro_torch.implicit.config import ImplicitConfig


@dataclasses.dataclass(frozen=True)
class BackwardConfig:
    """Legacy flat backward config; prefer ``ImplicitConfig.backward``."""

    mode: str = "shine"          # any name in repro_torch.implicit.ESTIMATORS
    max_steps: int = 30          # budget of the iterative part (full / refine)
    refine_steps: int = 5
    tol: float = 1e-6
    memory: int = 30
    fallback_ratio: float = 1.3
    unroll: bool = False

    def to_implicit(self) -> ImplicitConfig:
        return ImplicitConfig(
            forward=_ForwardConfig(),
            backward=_NewBackwardConfig(
                estimator=self.mode, max_steps=self.max_steps,
                refine_steps=self.refine_steps, tol=self.tol,
                fallback_ratio=self.fallback_ratio,
            ),
            memory=self.memory,
            unroll=self.unroll,
        )


def estimate_cotangent(mode_cfg: BackwardConfig | ImplicitConfig,
                       vjp_z: Callable[[torch.Tensor], torch.Tensor],
                       w: torch.Tensor, H: LowRank) -> AdjointResult:
    """Registry-dispatched estimate on the DEQ adjoint problem."""
    if isinstance(mode_cfg, BackwardConfig):
        mode_cfg = mode_cfg.to_implicit()
    return _estimators.estimate_cotangent(mode_cfg, vjp_z, w, H)
