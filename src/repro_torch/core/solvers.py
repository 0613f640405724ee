"""Broyden root solver whose inverse estimate SHINE shares.

The port of ``broyden_solve`` from ``repro/core/solvers.py`` with everything
that rides its loop: the persistent :class:`SolveCarry` and its helpers,
per-sample freeze masks, best-iterate tracking, the residual trace, the
:class:`~repro_torch.obs.tape.SolveTape` and the fault guard (per-sample
STATUS codes, entry repair of a poisoned warm start, one restart round).
The other solvers (Picard, Anderson, adjoint Broyden, L-BFGS) come with
later slices.

Eager PyTorch runs the loop on the host: the whole-batch early exit
(``all(converged)``) and the guard's "any restart" test read one flag each
per iteration.  Every solve is batched; converged, faulted and frozen
samples stop moving (their updates are masked out).  All inner products
and denominators are f32; the ring stores ``cfg.qn_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.lowrank import LowRank, _expand, bdot, bnorm
from repro_torch.obs.tape import SolveTape, empty_tape, tape_record

Tensor = torch.Tensor

STATUS_CONVERGED = 0
STATUS_MAX_ITERS = 1
STATUS_DIVERGED = 2
STATUS_NONFINITE = 3
STATUS_STALLED = 4

STATUS_NAMES = {
    STATUS_CONVERGED: "converged",
    STATUS_MAX_ITERS: "max_iters",
    STATUS_DIVERGED: "diverged",
    STATUS_NONFINITE: "nonfinite",
    STATUS_STALLED: "stalled",
}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the configs' spelling) -> dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Fault guard
# ---------------------------------------------------------------------------


class _GuardState(NamedTuple):
    """Per-sample fault-containment state riding a guarded solver loop."""

    sick: Tensor       # (B,) bool: faulted rows frozen out of the loop
    status: Tensor     # (B,) int32: sticky STATUS_* (MAX_ITERS while live)
    stall: Tensor      # (B,) int32: consecutive zero-step count
    restarts: Tensor   # (B,) int32: recovery rounds consumed
    stepscale: Tensor  # (B,) f32: damping multiplier (1.0 until a restart)


def _guard_init(bsz: int, device) -> _GuardState:
    return _GuardState(
        sick=torch.zeros((bsz,), dtype=torch.bool, device=device),
        status=torch.full((bsz,), STATUS_MAX_ITERS, dtype=torch.int32,
                          device=device),
        stall=torch.zeros((bsz,), dtype=torch.int32, device=device),
        restarts=torch.zeros((bsz,), dtype=torch.int32, device=device),
        stepscale=torch.ones((bsz,), dtype=torch.float32, device=device),
    )


def _guard_detect(gs: _GuardState, cfg: "SolverConfig", active: Tensor,
                  res: Tensor, step_norm: Tensor, div_ref: Tensor):
    """One iteration of per-sample fault detection (non-finite residual,
    divergence past ``divergence_ratio x`` the reference, or a stall) and
    recovery bookkeeping.  Returns ``(gs', do_restart, code, res_safe)``
    with non-finite residuals replaced by +inf."""
    finite = torch.isfinite(res)
    nonfin = active & ~finite
    div = active & finite & (
        res > cfg.divergence_ratio * torch.clamp(div_ref, min=cfg.eps))
    stall_hit = active & finite & (step_norm <= cfg.stall_tol)
    stall = torch.where(stall_hit, gs.stall + 1, torch.zeros_like(gs.stall))
    stalled = stall_hit & (stall >= cfg.stall_patience)
    fault = nonfin | div | stalled
    code = torch.where(
        nonfin, STATUS_NONFINITE,
        torch.where(div, STATUS_DIVERGED, STATUS_STALLED)).int()
    can_restart = gs.restarts < cfg.restart_budget
    do_restart = fault & can_restart
    freeze = fault & ~can_restart
    gs2 = _GuardState(
        sick=gs.sick | freeze,
        status=torch.where(fault, code, gs.status),
        stall=torch.where(fault, torch.zeros_like(stall), stall),
        restarts=gs.restarts + do_restart.int(),
        stepscale=torch.where(do_restart, gs.stepscale * cfg.restart_damping,
                              gs.stepscale),
    )
    res_safe = torch.where(finite, res, torch.full_like(res, float("inf")))
    return gs2, do_restart, code, res_safe


def _damped(p: Tensor, gs: _GuardState) -> Tensor:
    """Per-sample restart damping of a step; healthy rows keep ``p``."""
    damped = gs.stepscale < 1.0
    return torch.where(_expand(damped, p), _expand(gs.stepscale, p) * p, p)


def _exit_status(conv: Tensor, gs: _GuardState | None) -> Tensor:
    """Final per-sample status; fault codes are sticky, CONVERGED wins only
    over the pending MAX_ITERS code."""
    if gs is None:
        return torch.where(conv, STATUS_CONVERGED, STATUS_MAX_ITERS).int()
    faulted = gs.status >= STATUS_DIVERGED
    return torch.where(faulted, gs.status,
                       torch.where(conv, STATUS_CONVERGED, gs.status)).int()


def _guard_entry(cfg: "SolverConfig", carry, z0: Tensor, z_cold: Tensor):
    """Entry repair of a poisoned warm start: rows whose carried iterate is
    non-finite re-enter at the cold start with one recovery round consumed
    and a sticky NONFINITE status.  Returns ``(z0, gs0, bad)``; ``bad`` is
    None when nothing was checked."""
    if not cfg.guard:
        return z0, None, None
    bsz = z0.shape[0]
    gs0 = _guard_init(bsz, z0.device)
    if carry is None:
        return z0, gs0, None
    bad = ~torch.isfinite(z0.reshape(bsz, -1)).all(dim=-1)
    z0 = torch.where(_expand(bad, z0), z_cold, z0)
    gs0 = gs0._replace(
        status=torch.where(bad, STATUS_NONFINITE, gs0.status).int(),
        restarts=bad.int(),
        stepscale=torch.where(bad, cfg.restart_damping * gs0.stepscale,
                              gs0.stepscale),
    )
    return z0, gs0, bad


# ---------------------------------------------------------------------------
# Persistent solve state carried across solves
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolveCarry:
    """Reusable solver state threaded across solves (decode tokens, train
    steps): ``z (B, *F)`` the previous iterate, ``lowrank`` the qN ring with
    its per-sample ``count``, ``warm (B,)`` bool per-row validity (cold rows
    start from the caller's ``z0`` with an identity inverse) and ``age
    (B,)`` int32 solves since the row was last reset."""

    z: Tensor
    lowrank: LowRank
    warm: Tensor
    age: Tensor

    @property
    def memory(self) -> int:
        return self.lowrank.memory


def init_solve_carry(batch: int, feat: tuple[int, ...] | int, memory: int,
                     *, alpha: float = 1.0, dtype=torch.float32,
                     qn_dtype="bfloat16",
                     device: torch.device | str = "cpu") -> SolveCarry:
    """An all-cold carry; ``qn_dtype`` sets the ring storage dtype (None =
    the iterate dtype)."""
    feat = (feat,) if isinstance(feat, int) else tuple(feat)
    ring = torch_dtype(qn_dtype) if qn_dtype is not None else dtype
    return SolveCarry(
        z=torch.zeros((batch,) + feat, dtype=dtype, device=device),
        lowrank=LowRank.identity(batch, feat, memory, alpha=alpha,
                                 dtype=ring, device=device),
        warm=torch.zeros((batch,), dtype=torch.bool, device=device),
        age=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def reset_carry_rows(carry: SolveCarry, evict: Tensor) -> SolveCarry:
    """Rows where ``evict`` return to cold-start behaviour (``warm=False``,
    ring count zeroed; stale slot contents stay, masked invalid)."""
    keep = ~evict
    zero = torch.zeros_like(carry.lowrank.count)
    lr = dataclasses.replace(
        carry.lowrank, count=torch.where(keep, carry.lowrank.count, zero))
    return SolveCarry(z=carry.z, lowrank=lr, warm=carry.warm & keep,
                      age=torch.where(keep, carry.age,
                                      torch.zeros_like(carry.age)))


def carry_state_only(carry: SolveCarry) -> SolveCarry:
    """Drop the quasi-Newton chain from a carry (ring counts zeroed) and
    keep the iterate warm: with a fresh batch every step, a chain built on
    the previous step's samples degrades the solve, while the iterate
    carries the parameters' equilibrium structure over."""
    bsz = carry.z.shape[0]
    return dataclasses.replace(
        carry, lowrank=dataclasses.replace(
            carry.lowrank, count=torch.zeros((bsz,), dtype=torch.int32,
                                             device=carry.z.device)))


def seed_carry(carry: SolveCarry, z: Tensor) -> SolveCarry:
    """Warm-start every row at ``z`` with a fresh inverse (ring count
    zeroed) -- e.g. a prefill's last-token equilibrium seeding decode."""
    bsz = carry.z.shape[0]
    dev = carry.z.device
    return SolveCarry(
        z=z.to(carry.z.dtype),
        lowrank=dataclasses.replace(
            carry.lowrank,
            count=torch.zeros((bsz,), dtype=torch.int32, device=dev)),
        warm=torch.ones((bsz,), dtype=torch.bool, device=dev),
        age=torch.zeros((bsz,), dtype=torch.int32, device=dev),
    )


def _carry_start(carry: SolveCarry | None, z0: Tensor, memory: int):
    """Resolve the effective start ``(z0, init_lowrank)`` from a carry:
    warm rows start at ``carry.z`` with the carried chain, cold rows keep
    ``z0`` and see an empty chain (masked count)."""
    if carry is None:
        return z0, None
    if tuple(carry.lowrank.u.shape[1:]) != tuple(z0.shape):
        raise ValueError(
            f"carry memory shape {tuple(carry.lowrank.u.shape)} does not "
            f"match solver state {tuple(z0.shape)}")
    if carry.memory != memory:
        raise ValueError(
            f"carry holds {carry.memory} ring slots but the solver is "
            f"configured with memory={memory}; rebuild the carry")
    wm = _expand(carry.warm, z0)
    z_start = torch.where(wm, carry.z.to(z0.dtype), z0)
    H0 = dataclasses.replace(
        carry.lowrank,
        count=torch.where(carry.warm, carry.lowrank.count,
                          torch.zeros_like(carry.lowrank.count)))
    return z_start, H0


def _carry_out(carry: SolveCarry | None, z: Tensor, H: LowRank | None,
               entry_frozen: Tensor) -> SolveCarry | None:
    """Package the post-solve state as the next call's carry; rows frozen
    at entry keep their warm/age flags (their iterate and ring never
    moved)."""
    if carry is None:
        return None
    lr = carry.lowrank
    if H is not None:
        lr = LowRank(alpha=lr.alpha, u=H.u.to(lr.u.dtype),
                     v=H.v.to(lr.v.dtype), count=H.count)
    live = ~entry_frozen
    return SolveCarry(z=z.to(carry.z.dtype), lowrank=lr,
                      warm=carry.warm | live, age=carry.age + live.int())


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    max_steps: int = 30
    tol: float = 1e-4
    memory: int = 30
    step_size: float = 1.0
    # residual stop criterion: ||g(z)|| < tol * max(||z||, 1)
    relative: bool = True
    eps: float = 1e-8
    opa_freq: int = 0
    opa_t0: float = 1.0
    trace: bool = True
    unroll: bool = False
    # storage dtype of the qN ring (coefficients always accumulate f32)
    qn_dtype: str = "bfloat16"
    # numerical-fault guards (see repro/core/solvers.py for the semantics)
    guard: bool = True
    divergence_ratio: float = 1e4
    stall_patience: int = 3
    stall_tol: float = -1.0
    restart_budget: int = 1
    restart_damping: float = 1.0


class SolveResult(NamedTuple):
    z: Tensor                # (B, *F) best iterate
    lowrank: LowRank         # inverse estimate H ~= J_g(z*)^{-1}
    residual: Tensor         # (B,) best ||g||
    n_steps: int             # iterations executed
    converged: Tensor        # (B,) bool
    trace: Tensor            # (max_steps, B) residual history (inf-padded)
    aux: dict
    carry: SolveCarry | None = None
    tape: SolveTape | None = None
    status: Tensor | None = None  # (B,) int32 STATUS_*


def _entry_frozen(freeze_mask: Tensor | None, bsz: int, device) -> Tensor:
    if freeze_mask is None:
        return torch.zeros((bsz,), dtype=torch.bool, device=device)
    return freeze_mask


def _stop_threshold(g0_norm: Tensor, z_norm: Tensor,
                    cfg: SolverConfig) -> Tensor:
    if cfg.relative:
        return cfg.tol * torch.clamp(z_norm, min=1.0)
    return torch.full_like(g0_norm, cfg.tol)


def broyden_solve(
    g: Callable[[Tensor], Tensor],
    z0: Tensor,
    cfg: SolverConfig,
    *,
    init_lowrank: LowRank | None = None,
    alpha0: float = 1.0,
    freeze_mask: Tensor | None = None,
    carry: SolveCarry | None = None,
) -> SolveResult:
    """Solve ``g(z) = 0`` for a batch ``z0: (B, *F)`` with Broyden's good
    method, ``H_{n+1} = H_n + (s - H y)(s^T H) / (s^T H y)`` kept as one
    appended rank-one pair per step.

    The loop carries ``Hg = H_n g(z_n)`` so the direction is free, and each
    iteration is one fused U/V pass (``LowRank.broyden_step``): ``H
    g(z_{n+1})``, ``H^T s``, the denominator and the ring append together.
    The carried product is advanced by a rank-one correction with the
    appended and the evicted pair, both rounded through the ring's storage
    dtype exactly where the JAX solver rounds them.

    ``freeze_mask: (B,) bool`` freezes samples at entry (serving padding /
    finished slots); ``carry`` warm-starts per row and comes back updated in
    ``SolveResult.carry``.  On the card the ring is updated in place, so a
    carried ring is consumed by the solve that takes it.
    """
    bsz, feat = z0.shape[0], tuple(z0.shape[1:])
    dev = z0.device
    z_cold = z0  # pre-carry start: the guard's restart target
    z0, carry_H = _carry_start(carry, z0, cfg.memory)
    H0 = init_lowrank if init_lowrank is not None else carry_H
    if H0 is None:
        H0 = LowRank.identity(bsz, feat, cfg.memory, alpha=alpha0,
                              dtype=torch_dtype(cfg.qn_dtype), device=dev)

    z0, gs, bad0 = _guard_entry(cfg, carry, z0, z_cold)
    if bad0 is not None:
        # the poisoned rows' carried ring goes with the iterate: a NaN slot
        # would NaN every masked matvec (0 * NaN)
        bm = _expand(bad0, z0)[None]
        H0 = LowRank(alpha=H0.alpha,
                     u=torch.where(bm, torch.zeros((), dtype=H0.u.dtype,
                                                   device=dev), H0.u),
                     v=torch.where(bm, torch.zeros((), dtype=H0.v.dtype,
                                                   device=dev), H0.v),
                     count=torch.where(bad0, torch.zeros_like(H0.count),
                                       H0.count))

    g0 = g(z0)
    res0 = bnorm(g0)
    thresh = _stop_threshold(res0, bnorm(z0), cfg)
    div_ref = torch.maximum(res0, bnorm(z0))  # warm-start-safe scale
    Hg = H0.matvec(g0.float())

    trace = torch.full((max(cfg.max_steps, 1), bsz), float("inf"),
                       dtype=torch.float32, device=dev)
    tape = empty_tape(cfg.max_steps, bsz, dev)
    conv = res0 < thresh
    if freeze_mask is not None:
        conv = conv | freeze_mask
    k, z, gz, H = 0, z0, g0, H0
    best_z, best_res = z0, res0

    while k < cfg.max_steps:
        done = (conv | gs.sick) if cfg.guard else conv
        if bool(done.all()):
            break
        p = -Hg
        if cfg.guard:
            p = _damped(p, gs)
            active = ~(conv | gs.sick)
        else:
            active = ~conv
        am = _expand(active, z)
        z_new = torch.where(am, z + cfg.step_size * p.to(z.dtype), z)
        gz_new = torch.where(am, g(z_new), gz)

        s = (z_new - z).float()
        g_new32 = gz_new.float()
        wrapped = H.count >= H.memory                 # slot being overwritten
        # the per-step U/V stream: H g(z_new), H^T s, s^T H y and the
        # guarded ring append in one fused pass
        H, Hg_new, b, den, upd, ev_u, ev_v = H.broyden_step(
            g_new32, s, Hg, active, cfg.eps)
        Hy = Hg_new - Hg                              # H (g_new - g_old)
        denom = torch.where(den.abs() > cfg.eps, den, torch.ones_like(den))

        # advance the carried product to H_{n+1} g_new: add the appended
        # pair, remove the evicted one, both in storage precision
        a_st = ((s - Hy) / _expand(denom, s)).to(H.u.dtype).float()
        b_st = b.to(H.v.dtype).float()
        gain = a_st * _expand(bdot(b_st, g_new32), s)
        loss = ev_u.float() * _expand(
            bdot(ev_v.float(), g_new32) * wrapped.float(), s)
        Hg = Hg_new + _expand(upd.float(), s) * (gain - loss)

        res = bnorm(gz_new)
        do_rs = code = None
        if cfg.guard:
            gs, do_rs, code, res = _guard_detect(
                gs, cfg, active, res, bnorm(s), div_ref)
            if bool(do_rs.any()):
                # recovery round: scrub the restarted rows' ring, put them
                # back at the caller's z0 with the cold residual
                rm = _expand(do_rs, z)
                zu = torch.zeros((), dtype=H.u.dtype, device=dev)
                H = LowRank(alpha=H.alpha, u=torch.where(rm[None], zu, H.u),
                            v=torch.where(rm[None], zu, H.v),
                            count=torch.where(do_rs,
                                              torch.zeros_like(H.count),
                                              H.count))
                gz_cold = g0 if carry is None else g(z_cold)
                z_new = torch.where(rm, z_cold, z_new)
                gz_new = torch.where(rm, gz_cold, gz_new)
                Hg = torch.where(rm, H.alpha * gz_cold.float(), Hg)
                res = torch.where(do_rs, bnorm(gz_cold), res)
        improved = res < best_res
        best_z = torch.where(_expand(improved, z_new), z_new, best_z)
        best_res = torch.minimum(res, best_res)
        conv = conv | (res < thresh)
        trace[k] = torch.where(active, res, trace[k])
        status_k = None if gs is None else torch.where(do_rs, code,
                                                       gs.status)
        tape_record(tape, k, active, res, bnorm(s), H.count, status=status_k)
        z, gz = z_new, gz_new
        k += 1

    status = _exit_status(conv, gs)
    aux = {} if gs is None else {"restarts": gs.restarts, "sick": gs.sick}
    carry_out = _carry_out(carry, best_z, H,
                           _entry_frozen(freeze_mask, bsz, dev))
    if gs is not None and carry_out is not None:
        # sick rows hand the next solve a cold start, not a faulted state
        carry_out = reset_carry_rows(carry_out, gs.sick)
    return SolveResult(best_z, H, best_res, k, conv, trace, aux, carry_out,
                       tape, status)
