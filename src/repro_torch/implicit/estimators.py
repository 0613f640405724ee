"""Backward-pass cotangent estimators (paper §2) behind the registry.

The port of ``repro/implicit/estimators.py``.  Given the
fixed point ``z* = f(z*)`` (``g(z) = z - f(z) = 0``) and the loss cotangent
``w = dL/dz*``, the hypergradient needs ``u^T = w^T J_g(z*)^{-1}`` (then
``dL/dtheta = u^T df/dtheta``).  Registered estimators, each returning an
:class:`AdjointResult`:

  * ``full``            solve the adjoint system iteratively (Broyden; CG
                        in the bi-level problem).
  * ``shine``           ``u = H^T w`` with the forward solve's quasi-Newton
                        inverse ``H``: one ``qn_apply_multi`` with
                        ``transpose=(True,)``, no extra solve.
  * ``jfb``             ``u = w`` (Jacobian-free backprop).
  * ``shine_fallback``  shine, falling back to JFB per sample when
                        ``||H^T w|| > ratio * ||w||`` (the ``DEQSettings``
                        default).
  * ``shine_refine``    a few adjoint-solve iterations started at the
                        guarded shine estimate, warm-started with the
                        forward chain.
  * ``jfb_refine``      the same correction started at the JFB estimate.
  * ``shine_cascade``   shine for healthy samples; samples the forward guard
                        flagged, or whose shine estimate fails the norm test
                        or is non-finite, refine from the JFB start with the
                        healthy rows frozen.

The estimators are written once against an :class:`EstimatorContext` and
serve both problem classes: the DEQ adjoint (batched Broyden on ``(I -
J_f)^T u = w`` with a ``LowRank`` shared inverse, :func:`deq_context`) and
the bi-level hypergradient (CG on ``Hess q = w`` with the shared L-BFGS
two-loop inverse, :func:`bilevel_context`).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, NamedTuple

import torch

from repro_torch.core.lowrank import LowRank, _expand, bnorm
from repro_torch.core.solvers import (
    STATUS_DIVERGED,
    LBFGSMemory,
    SolveResult,
    SolverConfig,
    _lbfgs_gamma,
    broyden_solve,
    lbfgs_two_loop,
)
from repro_torch.implicit.registry import ESTIMATORS, register_estimator
from repro_torch.obs import metrics as obs_metrics

if TYPE_CHECKING:
    from repro_torch.implicit.config import ImplicitConfig

Tensor = torch.Tensor


class AdjointResult(NamedTuple):
    u: Tensor               # cotangent estimate (same shape as w)
    residual: Tensor        # final adjoint-system residual (nan if n/a)
    n_steps: int            # iterations of the iterative part
    fallback_mask: Tensor   # samples where the fallback guard fired


@dataclasses.dataclass
class EstimatorContext:
    """Everything an estimator may use.

    ``apply_inverse``  apply the shared (transposed) inverse estimate.
    ``solve``          ``(b, u0, steps, warm, freeze_mask=None) -> (u,
                       residual, n_steps)``: iteratively solve the adjoint
                       system from ``u0`` (``None`` = the solver's default
                       start); ``warm`` warm-starts with the forward chain;
                       ``freeze_mask`` pins those samples at ``u0``.
    ``norm``/``select`` per-sample norm and masked select.
    ``forward_status`` per-sample STATUS_* of the forward solve (or None).
    """

    w: Tensor
    apply_inverse: Callable[[Tensor], Tensor]
    solve: Callable[..., tuple[Tensor, Tensor, int]]
    norm: Callable[[Tensor], Tensor]
    select: Callable[[Tensor, Tensor, Tensor], Tensor]
    no_fallback: Tensor
    nan_residual: Tensor
    forward_status: Tensor | None = None


def shine_cotangent(H: LowRank, w: Tensor) -> Tensor:
    """``u = H^T w``: one stream over the forward chain."""
    return H.rmatvec(w)


def shine_cotangent_multi(H: LowRank, ws) -> tuple[Tensor, ...]:
    """``(H^T w_1, ..., H^T w_K)`` in one stream over the forward chain."""
    return H.matvec_multi(tuple(ws), (True,) * len(ws))


def jfb_cotangent(w: Tensor) -> Tensor:
    return w


def _select(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(_expand(mask, a), a, b)


def _fallback_rule(apply_inverse, norm, select, w: Tensor,
                   ratio: float) -> tuple[Tensor, Tensor]:
    """Paper §3: a SHINE inversion whose norm blows up past ``ratio`` times
    the JFB inversion's marks a bad inverse; fall back to JFB there."""
    u_shine = apply_inverse(w)
    bad = norm(u_shine) > ratio * norm(w)
    return select(bad, w, u_shine), bad


def fallback_cotangent(H: LowRank, w: Tensor,
                       ratio: float = 1.3) -> tuple[Tensor, Tensor]:
    """The guard applied to a ``LowRank`` shared inverse (batched form)."""
    return _fallback_rule(lambda v: shine_cotangent(H, v), bnorm, _select, w,
                          ratio)


def adjoint_system(vjp_z: Callable[[Tensor], Tensor],
                   w: Tensor) -> Callable[[Tensor], Tensor]:
    """``psi(u) = u - J_f^T u - w``; ``psi(u) = 0`` iff ``(I - J_f)^T u =
    w``."""
    def psi(u: Tensor) -> Tensor:
        return u - vjp_z(u) - w

    return psi


def solve_adjoint(vjp_z, w: Tensor, cfg: SolverConfig, *,
                  u0: Tensor | None = None,
                  init_lowrank: LowRank | None = None,
                  freeze_mask: Tensor | None = None) -> SolveResult:
    """Solve the adjoint system with Broyden; ``freeze_mask (B,)`` pins
    those samples at ``u0``."""
    psi = adjoint_system(vjp_z, w)
    u0 = w if u0 is None else u0
    return broyden_solve(psi, u0, cfg, init_lowrank=init_lowrank,
                         freeze_mask=freeze_mask)


# ---------------------------------------------------------------------------
# Registered estimators
# ---------------------------------------------------------------------------


def _guarded_shine(cfg: "ImplicitConfig",
                   ctx: EstimatorContext) -> tuple[Tensor, Tensor]:
    return _fallback_rule(ctx.apply_inverse, ctx.norm, ctx.select, ctx.w,
                          cfg.backward.fallback_ratio)


@register_estimator("jfb")
def _jfb(cfg: "ImplicitConfig", ctx: EstimatorContext) -> AdjointResult:
    return AdjointResult(ctx.w, ctx.nan_residual, 0, ctx.no_fallback)


@register_estimator("shine")
def _shine(cfg: "ImplicitConfig", ctx: EstimatorContext) -> AdjointResult:
    return AdjointResult(ctx.apply_inverse(ctx.w), ctx.nan_residual, 0,
                         ctx.no_fallback)


@register_estimator("shine_fallback")
def _shine_fallback(cfg: "ImplicitConfig",
                    ctx: EstimatorContext) -> AdjointResult:
    u, bad = _guarded_shine(cfg, ctx)
    return AdjointResult(u, ctx.nan_residual, 0, bad)


@register_estimator("shine_refine")
def _shine_refine(cfg: "ImplicitConfig",
                  ctx: EstimatorContext) -> AdjointResult:
    u0, bad = _guarded_shine(cfg, ctx)
    u, residual, n = ctx.solve(ctx.w, u0, cfg.backward.refine_steps, True)
    return AdjointResult(u, residual, n, bad)


@register_estimator("jfb_refine")
def _jfb_refine(cfg: "ImplicitConfig",
                ctx: EstimatorContext) -> AdjointResult:
    u, residual, n = ctx.solve(ctx.w, ctx.w, cfg.backward.refine_steps,
                               False)
    return AdjointResult(u, residual, n, ctx.no_fallback)


@register_estimator("full")
def _full(cfg: "ImplicitConfig", ctx: EstimatorContext) -> AdjointResult:
    u, residual, n = ctx.solve(ctx.w, None, cfg.backward.max_steps, False)
    return AdjointResult(u, residual, n, ctx.no_fallback)


@register_estimator("shine_cascade")
def _shine_cascade(cfg: "ImplicitConfig",
                   ctx: EstimatorContext) -> AdjointResult:
    """shine -> JFB start -> refine solve restricted to the flagged rows;
    a clean batch leaves the refine loop after 0 iterations with the exact
    shine cotangent."""
    u_shine = ctx.apply_inverse(ctx.w)
    n_shine = ctx.norm(u_shine)
    flagged = (n_shine > cfg.backward.fallback_ratio * ctx.norm(ctx.w)) \
        | ~torch.isfinite(n_shine)
    if ctx.forward_status is not None:
        flagged = flagged | (ctx.forward_status >= STATUS_DIVERGED)
    u0 = ctx.select(flagged, ctx.w, u_shine)
    u, residual, n = ctx.solve(ctx.w, u0, cfg.backward.refine_steps, True,
                               freeze_mask=~flagged)
    return AdjointResult(u, residual, n, flagged)


# ---------------------------------------------------------------------------
# The estimator contexts of the two problem classes, and dispatch
# ---------------------------------------------------------------------------


def _scrub_lowrank_rows(H: LowRank, rows: Tensor) -> LowRank:
    """Reset ``rows``' ring slots to the identity inverse (zeroed u/v,
    count 0): an escalated row's chain is what failed, and a non-finite
    slot would NaN the masked matvec (0 * NaN).  New buffers."""
    rm = _expand(rows, H.u[0])[None]
    zero = torch.zeros((), dtype=H.u.dtype, device=H.u.device)
    return LowRank(alpha=H.alpha, u=torch.where(rm, zero, H.u),
                   v=torch.where(rm, zero, H.v),
                   count=torch.where(rows, torch.zeros_like(H.count),
                                     H.count))


def deq_context(cfg: "ImplicitConfig", vjp_z: Callable[[Tensor], Tensor],
                w: Tensor, H: LowRank,
                forward_status: Tensor | None = None) -> EstimatorContext:
    """DEQ adjoint: batched Broyden on ``(I - J_f)^T u = w``; the shared
    inverse is the forward Broyden chain (transposed for warm starts)."""
    bsz = w.shape[0]

    def solve(b, u0, steps, warm, freeze_mask=None):
        init = None
        if warm:
            # the adjoint solve appends to its ring, in place on the card:
            # it gets buffers of its own, so the forward's ring (also the
            # carry under deq_carry="full") is left as it was
            init = H.transpose()
            init = (init.clone() if freeze_mask is None else
                    # escalation solve: the rows being solved start from
                    # the identity
                    _scrub_lowrank_rows(init, ~freeze_mask))
        res = solve_adjoint(vjp_z, b, cfg.adjoint_cfg(steps), u0=u0,
                            init_lowrank=init, freeze_mask=freeze_mask)
        obs_metrics.record_solve("backward", res)
        return res.z, res.residual, res.n_steps

    return EstimatorContext(
        w=w,
        apply_inverse=lambda v: shine_cotangent(H, v),
        solve=solve,
        norm=bnorm,
        select=_select,
        no_fallback=torch.zeros((bsz,), dtype=torch.bool, device=w.device),
        nan_residual=torch.full((bsz,), float("nan"), dtype=torch.float32,
                                device=w.device),
        forward_status=forward_status,
    )


def bilevel_context(cfg: "ImplicitConfig", hvp: Callable[[Tensor], Tensor],
                    w: Tensor, mem: LBFGSMemory) -> EstimatorContext:
    """Bi-level hypergradient: CG on ``Hess q = w``; the shared inverse is
    the forward L-BFGS memory applied by the two-loop recursion (``H`` is
    symmetric).  ``n_steps`` counts HVP calls."""
    gamma = _lbfgs_gamma(mem)

    def solve(b, u0, steps, warm, freeze_mask=None):
        # one problem: freeze_mask has no per-sample meaning here
        x0 = torch.zeros_like(b) if u0 is None else u0
        q, k = _cg(hvp, b, x0, steps, cfg.backward.tol)
        return q, torch.full((), float("nan"), device=b.device), k

    return EstimatorContext(
        w=w,
        apply_inverse=lambda v: lbfgs_two_loop(mem, v, gamma),
        solve=solve,
        norm=torch.linalg.vector_norm,
        select=torch.where,
        no_fallback=torch.zeros((), dtype=torch.bool, device=w.device),
        nan_residual=torch.full((), float("nan"), device=w.device),
    )


def _cg(hvp: Callable[[Tensor], Tensor], b: Tensor, x0: Tensor, steps: int,
        tol: float) -> tuple[Tensor, int]:
    """Plain conjugate gradient on a PD system; returns ``(x, iters)``.
    Host reads: one stop test per iteration, and one that ends an early
    stop."""
    r = b - hvp(x0)
    x, p, k = x0, r, 0
    done = torch.linalg.vector_norm(r) < tol
    while k < steps and not bool(done):
        hp = hvp(p)
        rr = torch.dot(r, r)
        alpha = rr / torch.clamp(torch.dot(p, hp), min=1e-30)
        x = x + alpha * p
        r_new = r - alpha * hp
        beta = torch.dot(r_new, r_new) / torch.clamp(rr, min=1e-30)
        p = r_new + beta * p
        r = r_new
        done = torch.linalg.vector_norm(r_new) < tol
        k += 1
    return x, k


def estimate_cotangent(cfg: "ImplicitConfig",
                       vjp_z: Callable[[Tensor], Tensor], w: Tensor,
                       H: LowRank,
                       forward_status: Tensor | None = None
                       ) -> AdjointResult:
    """Run the configured estimator on the DEQ adjoint problem."""
    estimator = ESTIMATORS.get(cfg.backward.estimator)
    return estimator(cfg, deq_context(cfg, vjp_z, w, H,
                                      forward_status=forward_status))


def estimate_hypergrad_cotangent(cfg: "ImplicitConfig",
                                 hvp: Callable[[Tensor], Tensor], w: Tensor,
                                 mem: LBFGSMemory) -> AdjointResult:
    """Run the configured estimator on the bi-level hypergradient problem."""
    estimator = ESTIMATORS.get(cfg.backward.estimator)
    return estimator(cfg, bilevel_context(cfg, hvp, w, mem))
