"""Root and fixed-point solvers whose inverse estimates SHINE shares.

The port of the DEQ solvers of ``repro/core/solvers.py``:

  * ``broyden_solve``          Broyden's good method (the DEQ forward);
  * ``adjoint_broyden_solve``  adjoint Broyden with the paper's OPA extra
                               updates (§2.3, Theorem 4);
  * ``fixed_point_solve``      damped Picard iteration and
  * ``anderson_solve``         type-II Anderson acceleration, the forward
                               solvers of the Jacobian-free baseline;

with everything that rides their loops: the persistent :class:`SolveCarry`
and its helpers, per-sample freeze masks, the residual trace, the
:class:`~repro_torch.obs.tape.SolveTape` and the fault guard (per-sample
STATUS codes, entry repair of a poisoned warm start, one restart round);
and ``lbfgs_solve``, L-BFGS with OPA's extra secant pairs, the inner solver
of the bi-level (HOAG) workloads, with its two-loop recursion, the inverse
estimate the hypergradient shares.

Eager PyTorch runs each loop on the host: the whole-batch early exit
(``all(converged)``) and, where a restart scrubs solver memory, the guard's
"any restart" test read one flag each per iteration; inside
``stop_tests_over(group)`` (a solve whose batch is split over ranks) each
such read is of one ``all_reduce`` over the group, so every rank takes the
same iterations (``STOP_READS`` counts the reads).
``SolverConfig.unroll`` has the reference's meaning in ``broyden_solve``
and ``fixed_point_solve``: ``max_steps`` bodies with no early exit and no
host read (the restart is a select on the device; converged rows are
masked out as always, so they end bit for bit where the early exit leaves
them).  The dry-run runs the solve so on ``meta`` tensors, where a host
read cannot be made; Anderson, adjoint Broyden and L-BFGS ignore it, as
in the reference.  Every solve is batched; converged, faulted and frozen
samples stop moving (their updates are masked out).  All inner products
and denominators are f32; the Broyden ring stores ``cfg.qn_dtype``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

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

# Armed by repro_torch.runtime.faultinject (chaos testing): when set, every
# batched solver perturbs its post-step iterate through this hook.  None
# costs a solver iteration one ``is not None`` test.
_FAULT_HOOK = None


# ---------------------------------------------------------------------------
# stop and restart tests: host reads, one per test, global on a mesh
# ---------------------------------------------------------------------------

# the process group whose ranks hold the other rows of a batch-split solve
# (``stop_tests_over``); None: the rows are all here
_STOP_GROUP: list = [None]
# host reads the stop and restart tests made (the count every rank of a
# split solve must agree on)
STOP_READS: list = [0]


@contextlib.contextmanager
def stop_tests_over(group):
    """Make every stop and restart test global over ``group`` for the
    solves inside: a rank holds some rows of the batch, the test reads
    the reduction over all of them (one ``all_reduce`` of one integer per
    test), so every rank stops and restarts at the same iteration, as the
    reference's global ``while_loop`` predicate does.  ``group`` None is
    the default world."""
    prev = _STOP_GROUP[0]
    _STOP_GROUP[0] = dist.group.WORLD if group is None else group
    try:
        yield
    finally:
        _STOP_GROUP[0] = prev


def _read(flag: Tensor, op) -> bool:
    STOP_READS[0] += 1
    if _STOP_GROUP[0] is None:
        return bool(flag)
    x = flag.to(torch.int32).reshape(1)
    dist.all_reduce(x, op=op, group=_STOP_GROUP[0])
    return bool(x)


def _all_rows(t: Tensor) -> bool:
    """``bool(t.all())`` over every rank's rows."""
    return _read(t.all(), dist.ReduceOp.MIN)


def _any_row(t: Tensor) -> bool:
    """``bool(t.any())`` over every rank's rows."""
    return _read(t.any(), dist.ReduceOp.MAX)


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


def _guard_init(bsz: int | None, device) -> _GuardState:
    """``bsz=None``: the scalar state of L-BFGS's one problem."""
    shape = () if bsz is None else (bsz,)
    return _GuardState(
        sick=torch.zeros(shape, dtype=torch.bool, device=device),
        status=torch.full(shape, STATUS_MAX_ITERS, dtype=torch.int32,
                          device=device),
        stall=torch.zeros(shape, dtype=torch.int32, device=device),
        restarts=torch.zeros(shape, dtype=torch.int32, device=device),
        stepscale=torch.ones(shape, dtype=torch.float32, device=device),
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
    # max_steps iterations, no early exit, no host read (broyden_solve and
    # fixed_point_solve; the dry-run's form)
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


def _guard_aux(gs: _GuardState | None) -> dict:
    return {} if gs is None else {"restarts": gs.restarts, "sick": gs.sick}


def _finish_carry(carry, z, H, freeze_mask, gs, bsz, dev):
    carry_out = _carry_out(carry, z, H, _entry_frozen(freeze_mask, bsz, dev))
    if gs is not None and carry_out is not None:
        # sick rows hand the next solve a cold start, not a faulted state
        carry_out = reset_carry_rows(carry_out, gs.sick)
    return carry_out


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

    ``cfg.unroll``: all ``max_steps`` iterations without a host read; the
    guard's ring scrub is a select, and with a carry the cold residual
    ``g(z_cold)`` is evaluated once before the loop (without ``unroll``
    only when a restart fires).
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
    # the restart target's residual (the entry point's when cold)
    gz_cold = g0 if carry is None or not (cfg.guard and cfg.unroll) \
        else g(z_cold)

    while k < cfg.max_steps:
        done = (conv | gs.sick) if cfg.guard else conv
        if not cfg.unroll and _all_rows(done):
            break
        p = -Hg
        if cfg.guard:
            p = _damped(p, gs)
            active = ~(conv | gs.sick)
        else:
            active = ~conv
        am = _expand(active, z)
        z_new = torch.where(am, z + cfg.step_size * p.to(z.dtype), z)
        if _FAULT_HOOK is not None:
            z_new = _FAULT_HOOK(z_new, k, z)
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
            if cfg.unroll or _any_row(do_rs):
                # recovery round: scrub the restarted rows' ring, put them
                # back at the caller's z0 with the cold residual (unrolled:
                # as selects, a no-op for rows that did not restart)
                rm = _expand(do_rs, z)
                zu = torch.zeros((), dtype=H.u.dtype, device=dev)
                H = LowRank(alpha=H.alpha, u=torch.where(rm[None], zu, H.u),
                            v=torch.where(rm[None], zu, H.v),
                            count=torch.where(do_rs,
                                              torch.zeros_like(H.count),
                                              H.count))
                if not cfg.unroll and carry is not None:
                    gz_cold = g(z_cold)
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

    return SolveResult(best_z, H, best_res, k, conv, trace, _guard_aux(gs),
                       _finish_carry(carry, best_z, H, freeze_mask, gs, bsz,
                                     dev),
                       tape, _exit_status(conv, gs))


# ---------------------------------------------------------------------------
# Fixed-point / Anderson (the Jacobian-free baseline's forward)
# ---------------------------------------------------------------------------


def _placeholder_inverse(z: Tensor) -> LowRank:
    """The identity "inverse" Picard and Anderson hand the backward (JFB
    shares I).  The JAX package's is a ``(1, B, 1)`` ring that broadcasts
    against the state; this one has the state's feature shape and one empty
    slot (count 0), so ``H^T w`` is ``w`` exactly, through the same
    ``qn_apply_multi`` kernel on the card as on any other ring."""
    return LowRank.identity(z.shape[0], tuple(z.shape[1:]), 1, alpha=1.0,
                            dtype=torch.float32, device=z.device)


def fixed_point_solve(
    f: Callable[[Tensor], Tensor],
    z0: Tensor,
    cfg: SolverConfig,
    *,
    damping: float = 1.0,
    freeze_mask: Tensor | None = None,
    carry: SolveCarry | None = None,
) -> SolveResult:
    """Damped Picard iteration ``z <- (1-d) z + d f(z)``; residual
    ``f(z) - z``.

    Carry reuse is iterate-only (Picard keeps no quasi-Newton memory): warm
    rows start at ``carry.z`` and the carried ring passes through untouched.
    The guard's restart damping scales the mixing per row; healthy rows
    select the undamped expression bit for bit.  Returns the last iterate
    with the best residual seen, and :func:`_placeholder_inverse` as ``H``.
    ``cfg.unroll``: all ``max_steps`` iterations without a host read.
    """
    bsz, dev = z0.shape[0], z0.device
    z_cold = z0  # pre-carry start: the guard's restart target
    if carry is not None:
        z0, _ = _carry_start(carry, z0, carry.memory)  # validates shapes
    z0, gs, _bad0 = _guard_entry(cfg, carry, z0, z_cold)
    H = _placeholder_inverse(z0)
    res0 = bnorm(f(z0) - z0)
    thresh = _stop_threshold(res0, bnorm(z0), cfg)
    div_ref = torch.maximum(res0, bnorm(z0))  # warm-start-safe scale
    trace = torch.full((max(cfg.max_steps, 1), bsz), float("inf"),
                       dtype=torch.float32, device=dev)
    tape = empty_tape(cfg.max_steps, bsz, dev)
    no_qn = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    conv = res0 < thresh
    if freeze_mask is not None:
        conv = conv | freeze_mask
    k, z, best_res = 0, z0, res0

    while k < cfg.max_steps:
        done = (conv | gs.sick) if cfg.guard else conv
        if not cfg.unroll and _all_rows(done):
            break
        fz = f(z)
        z_pic = (1 - damping) * z + damping * fz
        if cfg.guard:
            # restart damping scales the mixing factor per sample (the
            # product is cast back: an f32 scale must not widen the state)
            d2 = _expand(damping * gs.stepscale, z)
            z_dampd = ((1 - d2) * z + d2 * fz).to(z.dtype)
            z_pic = torch.where(_expand(gs.stepscale < 1.0, z), z_dampd,
                                z_pic)
        z_new = torch.where(_expand(done, z), z, z_pic)
        if _FAULT_HOOK is not None:
            z_new = _FAULT_HOOK(z_new, k, z)
        res = bnorm(fz - z)
        step_n = bnorm(z_new - z)
        status_k = None
        if cfg.guard:
            gs, do_rs, code, res = _guard_detect(gs, cfg, ~done, res, step_n,
                                                 div_ref)
            z_new = torch.where(_expand(do_rs, z), z_cold, z_new)
            status_k = torch.where(do_rs, code, gs.status)
        trace[k] = torch.where(done, trace[k], res)
        tape_record(tape, k, ~done, res, step_n, no_qn, status=status_k)
        best_res = torch.minimum(best_res, res)
        conv = conv | (res < thresh)
        z = z_new
        k += 1

    return SolveResult(z, H, best_res, k, conv, trace, _guard_aux(gs),
                       _finish_carry(carry, z, None, freeze_mask, gs, bsz,
                                     dev),
                       tape, _exit_status(conv, gs))


def anderson_solve(
    f: Callable[[Tensor], Tensor],
    z0: Tensor,
    cfg: SolverConfig,
    *,
    mixing: float = 1.0,
    ridge: float = 1e-8,
    freeze_mask: Tensor | None = None,
    carry: SolveCarry | None = None,
) -> SolveResult:
    """Type-II Anderson acceleration with a window of ``min(cfg.memory,
    8)``.

    The iterate and residual windows ``Z``/``F`` ``(m, B, *F)`` live in the
    state dtype; the per-sample Gram matrix and its small solve run in f32
    (plain PyTorch: the JAX package computes them outside any kernel).  A
    row whose mixture is non-finite takes the Picard step; a restarted row's
    window is scrubbed to ``Z = z_cold``, ``F = 0``.  Carry reuse is
    iterate-only, as for :func:`fixed_point_solve`.
    """
    bsz, feat, dev = z0.shape[0], tuple(z0.shape[1:]), z0.device
    m = min(cfg.memory, 8)
    z_cold = z0  # pre-carry start: the guard's restart target
    if carry is not None:
        z0, _ = _carry_start(carry, z0, carry.memory)  # validates shapes
    z0, gs, _bad0 = _guard_entry(cfg, carry, z0, z_cold)
    res0 = bnorm(f(z0) - z0)
    thresh = _stop_threshold(res0, bnorm(z0), cfg)
    div_ref = torch.maximum(res0, bnorm(z0))  # warm-start-safe scale
    trace = torch.full((max(cfg.max_steps, 1), bsz), float("inf"),
                       dtype=torch.float32, device=dev)
    tape = empty_tape(cfg.max_steps, bsz, dev)
    Z = torch.zeros((m, bsz) + feat, dtype=z0.dtype, device=dev)  # iterates
    F = torch.zeros((m, bsz) + feat, dtype=z0.dtype, device=dev)  # residuals
    eye = torch.eye(m, dtype=torch.float32, device=dev)
    conv = res0 < thresh
    if freeze_mask is not None:
        conv = conv | freeze_mask
    k, z = 0, z0

    while k < cfg.max_steps:
        done = (conv | gs.sick) if cfg.guard else conv
        if _all_rows(done):
            break
        fz = f(z)
        r = fz - z
        Z[k % m] = fz
        F[k % m] = r
        nk = min(k + 1, m)
        valid = (torch.arange(m, device=dev) < nk).float()          # (m,)
        vv = valid[:, None] * valid[None, :]
        # min ||sum_i w_i F_i|| s.t. sum w = 1 (normal equations, f32);
        # one (m, D) x (D, m) product per sample: cuBLAS streams those at
        # several times the rate of the batched einsum's long-K kernel
        F32 = F.reshape(m, bsz, -1).float()
        G = torch.stack([F32[:, i] @ F32[:, i].T for i in range(bsz)])
        G = G * vv[None]
        G = G + (ridge + (1 - vv))[None] * eye[None]
        ones = valid[None, :, None].expand(bsz, m, 1)
        # solve_ex: a rank-deficient window gives non-finite weights (the
        # mix_ok rows below), as jnp.linalg.solve does, not an exception
        w = torch.linalg.solve_ex(G, ones)[0][..., 0] * valid[None]
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
        z_and = torch.einsum("bi,ibx->bx", w, Z.reshape(m, bsz, -1).float()
                             ).reshape(z.shape).to(z.dtype)
        z_mix = (1 - mixing) * z + mixing * z_and
        if cfg.guard:
            # restart damping scales the mixing per sample; healthy rows
            # select the undamped expression bit for bit
            mx = _expand(mixing * gs.stepscale, z)
            z_dampd = ((1 - mx) * z + mx * z_and).to(z.dtype)
            z_mix = torch.where(_expand(gs.stepscale < 1.0, z), z_dampd,
                                z_mix)
            # a rank-deficient window (e.g. just after a restart scrub)
            # NaNs the weight solve: those rows take the Picard step
            mix_ok = torch.isfinite(z_mix.reshape(bsz, -1)).all(dim=-1)
            z_mix = torch.where(_expand(mix_ok, z), z_mix, fz)
        z_new = torch.where(_expand(done, z), z, z_mix)
        if _FAULT_HOOK is not None:
            z_new = _FAULT_HOOK(z_new, k, z)
        res = bnorm(r)
        step_n = bnorm(z_new - z)
        status_k = None
        if cfg.guard:
            gs, do_rs, code, res = _guard_detect(gs, cfg, ~done, res, step_n,
                                                 div_ref)
            rm = _expand(do_rs, z)
            if _any_row(do_rs):
                # scrub the restarted rows' window to Z = z_cold, F = 0:
                # identical non-zero sentinels would make the Gram matrix
                # rank-deficient beyond the ridge's f32 reach, while F = 0
                # leaves those slots at exactly ridge * I
                Z = torch.where(rm[None], z_cold[None].to(Z.dtype), Z)
                F = torch.where(rm[None], torch.zeros((), dtype=F.dtype,
                                                      device=dev), F)
            z_new = torch.where(rm, z_cold, z_new)
            status_k = torch.where(do_rs, code, gs.status)
        trace[k] = torch.where(done, trace[k], res)
        # qn_count reports the window fill
        tape_record(tape, k, ~done, res, step_n,
                    torch.full((bsz,), nk, dtype=torch.int32, device=dev),
                    status=status_k)
        conv = conv | (res < thresh)
        z = z_new
        k += 1

    final_res = bnorm(f(z) - z)
    if cfg.guard:
        # a sick row's iterate may be non-finite; report +inf, not NaN
        final_res = torch.where(gs.sick, torch.full_like(final_res,
                                                         float("inf")),
                                final_res)
    return SolveResult(z, _placeholder_inverse(z), final_res, k, conv, trace,
                       _guard_aux(gs),
                       _finish_carry(carry, z, None, freeze_mask, gs, bsz,
                                     dev),
                       tape, _exit_status(conv, gs))


# ---------------------------------------------------------------------------
# Adjoint Broyden with OPA (paper §2.3, Theorem 4)
# ---------------------------------------------------------------------------


def _g_with_vjp(g: Callable[[Tensor], Tensor], z: Tensor):
    """``g(z)`` and its VJP ``sigma -> sigma^T J_g(z)`` (f32) from one graph
    built for ``z`` alone: gradients are on for a detached leaf only, so no
    parameter ``.grad`` accumulates, and the graph dies with the returned
    closure (``keep=True`` retains it for one more VJP at the same
    point)."""
    with torch.enable_grad():
        zl = z.detach().requires_grad_(True)
        out = g(zl)

    def vjp(sigma: Tensor, keep: bool = False) -> Tensor:
        return torch.autograd.grad(out, zl, sigma.to(out.dtype),
                                   retain_graph=keep)[0].float()

    return out.detach(), vjp


def adjoint_broyden_solve(
    g: Callable[[Tensor], Tensor],
    z0: Tensor,
    cfg: SolverConfig,
    *,
    outer_grad: Callable[[Tensor], Tensor] | None = None,
    freeze_mask: Tensor | None = None,
    carry: SolveCarry | None = None,
) -> SolveResult:
    """Adjoint Broyden: the secant ``sigma^T B_{n+1} = sigma^T
    J_g(z_{n+1})``.

    Keeps both chains exactly, in f32 whatever ``cfg.qn_dtype`` says: ``B =
    I + sum sigma_i w_i^T`` (appended) and ``H = B^{-1}`` by
    Sherman-Morrison, since the update needs ``sigma^T B`` (cheap on the B
    chain) while the steps need ``H g``.  Each iteration applies them in
    three ``qn_apply_multi`` calls (``H g``; ``B^T sigma``; ``H sigma`` with
    ``w^T H`` as one mixed pair) and takes one VJP of ``g`` at the new
    iterate, from the same graph that evaluates ``g`` there.

    OPA: every ``cfg.opa_freq`` steps an extra update in the direction
    ``sigma = H^T dL/dz(z_n)`` (Eq. 8), the direction the hypergradient
    consumes; it needs ``outer_grad`` and reuses the iteration's graph.

    Carry reuse is iterate-only: warm-starting ``H`` without ``B`` would
    break ``H = B^{-1}``.  The new H chain goes into the returned carry
    (cast to the carry's ring dtype); ``aux["B"]`` holds the B chain.  A
    guard restart scrubs both chains for the row, together.  Returns the
    last iterate.
    """
    bsz, feat, dev = z0.shape[0], tuple(z0.shape[1:]), z0.device
    z_cold = z0  # pre-carry start: the guard's restart target
    z0, _ = _carry_start(carry, z0, cfg.memory)  # validates; H not reused
    z0, gs, _bad0 = _guard_entry(cfg, carry, z0, z_cold)
    B = LowRank.identity(bsz, feat, cfg.memory, alpha=1.0,
                         dtype=torch.float32, device=dev)
    H = LowRank.identity(bsz, feat, cfg.memory, alpha=1.0,
                         dtype=torch.float32, device=dev)

    g0 = g(z0)
    res0 = bnorm(g0)
    thresh = _stop_threshold(res0, bnorm(z0), cfg)
    div_ref = torch.maximum(res0, bnorm(z0))  # warm-start-safe scale
    trace = torch.full((max(cfg.max_steps, 1), bsz), float("inf"),
                       dtype=torch.float32, device=dev)
    tape = empty_tape(cfg.max_steps, bsz, dev)
    one = torch.ones((bsz,), dtype=torch.float32, device=dev)

    def update_chains(B, H, vjp, sigma, active, keep):
        # sigma^T J at z_new by the VJP; sigma^T B on the B chain
        sJT = vjp(sigma, keep)
        sB = B.rmatvec(sigma)
        ss = bdot(sigma, sigma)
        safe = ss > cfg.eps
        w_row = (sJT - sB) / _expand(torch.where(safe, ss, one), sJT)
        # H <- H - (H sigma)(w^T H) / (1 + w^T H sigma): one U/V stream
        Hs, wH = H.matvec_multi((sigma, w_row), (False, True))
        den = 1.0 + bdot(w_row, Hs)
        safe = safe & (den.abs() > cfg.eps)
        a = -Hs / _expand(torch.where(safe, den, one), Hs)
        return (B.append(sigma, w_row, active & safe),
                H.append(a, wH, active & safe))

    conv = res0 < thresh
    if freeze_mask is not None:
        conv = conv | freeze_mask
    k, z, gz = 0, z0, g0

    while k < cfg.max_steps:
        done = (conv | gs.sick) if cfg.guard else conv
        if _all_rows(done):
            break
        active = ~done
        am = _expand(active, z)
        p = -H.matvec(gz.float())
        if cfg.guard:
            p = _damped(p, gs)
        z_new = torch.where(am, z + cfg.step_size * p.to(z.dtype), z)
        if _FAULT_HOOK is not None:
            z_new = _FAULT_HOOK(z_new, k, z)
        g_at, vjp = _g_with_vjp(g, z_new)
        gz_new = torch.where(am, g_at, gz)

        sigma = gz_new.float()
        opa = (outer_grad is not None and cfg.opa_freq > 0
               and k % cfg.opa_freq == cfg.opa_freq - 1)
        B2, H2 = update_chains(B, H, vjp, sigma, active, keep=opa)
        if opa:
            w = outer_grad(z_new).float()
            sigma_e = H2.rmatvec(w)  # v_n = (dL/dz B^{-1})^T   (Eq. 8)
            B2, H2 = update_chains(B2, H2, vjp, sigma_e, active, keep=False)
        del vjp  # frees the iteration's graph

        res = bnorm(gz_new)
        status_k = None
        if cfg.guard:
            gs, do_rs, code, res = _guard_detect(
                gs, cfg, active, res, bnorm(z_new - z), div_ref)
            if _any_row(do_rs):
                # recovery round: scrub BOTH chains for the restarted rows
                # (H = B^{-1} holds only if they reset together) and go
                # back to the cold start
                rm = _expand(do_rs, z)
                B2, H2 = (LowRank(alpha=c.alpha,
                                  u=torch.where(rm[None], 0.0, c.u),
                                  v=torch.where(rm[None], 0.0, c.v),
                                  count=torch.where(do_rs,
                                                    torch.zeros_like(c.count),
                                                    c.count))
                          for c in (B2, H2))
                gz_cold = g0 if carry is None else g(z_cold)
                z_new = torch.where(rm, z_cold, z_new)
                gz_new = torch.where(rm, gz_cold, gz_new)
                res = torch.where(do_rs, bnorm(gz_cold), res)
            status_k = torch.where(do_rs, code, gs.status)
        trace[k] = torch.where(active, res, trace[k])
        tape_record(tape, k, active, res, bnorm(z_new - z), H2.count,
                    status=status_k)
        conv = conv | (res < thresh)
        z, gz, B, H = z_new, gz_new, B2, H2
        k += 1

    final_res = bnorm(gz)
    if cfg.guard:
        final_res = torch.where(gs.sick, torch.full_like(final_res,
                                                         float("inf")),
                                final_res)
    aux = {"B": B, **_guard_aux(gs)}
    return SolveResult(z, H, final_res, k, conv, trace, aux,
                       _finish_carry(carry, z, H, freeze_mask, gs, bsz, dev),
                       tape, _exit_status(conv, gs))


# ---------------------------------------------------------------------------
# (L)BFGS with OPA extra secant pairs (paper Alg. LBFGS, Thm 3)
# ---------------------------------------------------------------------------


class LBFGSMemory(NamedTuple):
    s: Tensor      # (m, D) f32
    y: Tensor      # (m, D) f32
    rho: Tensor    # (m,) f32
    count: Tensor  # () int32: total pairs ever stored (ring)


def empty_lbfgs_memory(memory: int, dim: int,
                       device: torch.device | str = "cpu") -> LBFGSMemory:
    return LBFGSMemory(
        s=torch.zeros((memory, dim), dtype=torch.float32, device=device),
        y=torch.zeros((memory, dim), dtype=torch.float32, device=device),
        rho=torch.zeros((memory,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def lbfgs_two_loop_multi(mem: LBFGSMemory, vs, gamma=1.0) -> tuple:
    """Apply the L-BFGS inverse-Hessian estimate ``H`` to K vectors in one
    pass over the ``(m, D)`` memory, newest pair to oldest and back (``H``
    is symmetric: there is no transposed variant).

    The ring is put in newest-to-oldest order once, by a gather on the
    device, so the recursion indexes it with host ints: no host read.  A
    slot past the valid count contributes exactly zero, as in the JAX
    package's masked scan."""
    m = mem.s.shape[0]
    dev = mem.s.device
    ar = torch.arange(m, device=dev)
    order = ((mem.count - 1 - ar) % m).long()
    valid = ar < torch.clamp(mem.count, max=m)                     # (m,)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    S = torch.where(valid[:, None], mem.s.index_select(0, order), zero)
    Y = torch.where(valid[:, None], mem.y.index_select(0, order), zero)
    rho = mem.rho.index_select(0, order)
    q = torch.stack([v.float() for v in vs])                       # (K, D)
    alphas = []
    for i in range(m):
        alpha = torch.where(valid[i], rho[i] * (q @ S[i]), zero)   # (K,)
        q = q - alpha[:, None] * Y[i][None, :]
        alphas.append(alpha)
    r = gamma * q
    for j in reversed(range(m)):
        beta = torch.where(valid[j], rho[j] * (r @ Y[j]), zero)
        r = r + (alphas[j] - beta)[:, None] * S[j][None, :]
    return tuple(r[k] for k in range(r.shape[0]))


def lbfgs_two_loop(mem: LBFGSMemory, v: Tensor, gamma=1.0) -> Tensor:
    """Apply the L-BFGS inverse-Hessian estimate to ``v`` (the two-loop
    recursion): the SHINE operation of the bi-level setting, sharing ``H``
    with the hypergradient instead of a fresh CG solve."""
    return lbfgs_two_loop_multi(mem, (v,), gamma)[0]


def _mem_push(mem: LBFGSMemory, s: Tensor, y: Tensor, accept) -> LBFGSMemory:
    """Write the pair into slot ``count % m`` when ``accept`` and the
    curvature ``s^T y`` is positive; new buffers (the caller's memory, e.g.
    HOAG's warm start, stays as it was)."""
    sy = torch.dot(s, y)
    ok = (sy > 1e-12) & accept
    slot = (mem.count % mem.s.shape[0]).long().reshape(1)
    s_new = torch.where(ok, s, mem.s.index_select(0, slot)[0])
    y_new = torch.where(ok, y, mem.y.index_select(0, slot)[0])
    rho_new = torch.where(ok, 1.0 / torch.clamp(sy, min=1e-12),
                          mem.rho.index_select(0, slot)[0])
    return LBFGSMemory(
        s=mem.s.index_copy(0, slot, s_new[None]),
        y=mem.y.index_copy(0, slot, y_new[None]),
        rho=mem.rho.index_copy(0, slot, rho_new.reshape(1)),
        count=mem.count + ok.int())


def _lbfgs_gamma(mem: LBFGSMemory) -> Tensor:
    """Standard ``H0`` scaling ``gamma = s'y / y'y`` of the newest pair."""
    has = mem.count > 0
    idx = ((mem.count - 1) % mem.s.shape[0]).long().reshape(1)
    s = mem.s.index_select(0, idx)[0]
    y = mem.y.index_select(0, idx)[0]
    sy, yy = torch.dot(s, y), torch.dot(y, y)
    return torch.where(has & (yy > 1e-12),
                       torch.clamp(sy, min=1e-12) / torch.clamp(yy, min=1e-12),
                       torch.ones_like(sy))


class LBFGSResult(NamedTuple):
    z: Tensor
    memory: LBFGSMemory
    grad_norm: Tensor
    n_steps: int
    converged: Tensor
    trace: Tensor
    tape: SolveTape | None = None   # (max_steps,) scalar-problem tape
    status: Tensor | None = None    # () int32 STATUS_*


def _line_search(value_fn, z: Tensor, p: Tensor, gz: Tensor, fz: Tensor,
                 max_ls: int) -> float:
    """Backtracking Armijo; returns the step length.  Each test is a host
    read (the JAX package's inner ``while_loop``)."""
    gp = torch.dot(gz, p)
    alpha = 1.0
    for _ in range(max_ls):
        fa = value_fn(z + alpha * p)
        if _all_rows(fa <= fz + 1e-4 * alpha * gp):
            break
        alpha *= 0.5
    return alpha


def lbfgs_solve(
    grad_fn: Callable[[Tensor], Tensor],
    z0: Tensor,                       # (D,)
    cfg: SolverConfig,
    *,
    value_fn: Callable[[Tensor], Tensor] | None = None,
    dg_dtheta: Callable[[Tensor], Tensor] | None = None,
    max_ls: int = 20,
    mem0: LBFGSMemory | None = None,
) -> LBFGSResult:
    """L-BFGS minimisation through the gradient ``grad_fn`` (``g_theta`` of
    the paper's Eq. 2), in f32.

    ``mem0`` warm-starts the secant memory (HOAG passes the previous outer
    iterate's, so the inner solve and the inverse estimate the
    hypergradient shares both resume).  Line search: backtracking Armijo
    on ``value_fn`` when given, else the fixed ``cfg.step_size``.  OPA
    (``cfg.opa_freq = M > 0`` with ``dg_dtheta``): every M steps an extra
    pair ``(e, g(z + e) - g(z))`` with ``e = t H dg/dtheta``, ``t =
    min(||s||, opa_t0)``, goes into the same memory.

    Host reads: one stop test per iteration (and the one that ends an
    early stop) plus one per line-search test; the guard's restart is a
    masked select, no read."""
    dim, m, dev = z0.shape[0], cfg.memory, z0.device
    if mem0 is None:
        mem0 = empty_lbfgs_memory(m, dim, dev)
    elif tuple(mem0.s.shape) != (m, dim):
        raise ValueError(f"mem0 holds {tuple(mem0.s.shape)} but the solver "
                         f"needs ({m}, {dim})")
    g0 = grad_fn(z0)
    gn0 = torch.linalg.vector_norm(g0)
    z0f, g0f = z0.float(), g0.float()
    trace = torch.full((max(cfg.max_steps, 1),), float("inf"),
                       dtype=torch.float32, device=dev)
    tape = empty_tape(cfg.max_steps, None, dev)
    gs = _guard_init(None, dev) if cfg.guard else None
    live = torch.ones((), dtype=torch.bool, device=dev)
    k, z, gz, mem, done = 0, z0f, g0f, mem0, gn0 < cfg.tol

    while k < cfg.max_steps:
        if _all_rows((done | gs.sick) if cfg.guard else done):
            break
        p = -lbfgs_two_loop(mem, gz, _lbfgs_gamma(mem))
        if value_fn is not None:
            alpha = _line_search(value_fn, z, p, gz, value_fn(z), max_ls)
        else:
            alpha = cfg.step_size
        if cfg.guard:
            alpha = torch.where(gs.stepscale < 1.0, gs.stepscale * alpha,
                                torch.full_like(gs.stepscale, alpha))
        z_new = z + alpha * p
        g_new = grad_fn(z_new).float()
        s = z_new - z
        mem = _mem_push(mem, s, g_new - gz, True)
        if dg_dtheta is not None and cfg.opa_freq > 0 and \
                k % cfg.opa_freq == cfg.opa_freq - 1:
            t_n = torch.clamp(torch.linalg.vector_norm(s), max=cfg.opa_t0)
            d = dg_dtheta(z_new).float()
            e = t_n * lbfgs_two_loop(mem, d, _lbfgs_gamma(mem))
            mem = _mem_push(mem, e, grad_fn(z_new + e).float() - g_new, True)

        gn = torch.linalg.vector_norm(g_new)
        s_norm = torch.linalg.vector_norm(s)
        status_k = None
        if cfg.guard:
            # one problem: the loop runs only while it is live
            gs, do_rs, code, gn = _guard_detect(gs, cfg, live, gn, s_norm,
                                                gn0)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            mem = LBFGSMemory(torch.where(do_rs, zero, mem.s),
                              torch.where(do_rs, zero, mem.y),
                              torch.where(do_rs, zero, mem.rho),
                              torch.where(do_rs, torch.zeros_like(mem.count),
                                          mem.count))
            z_new = torch.where(do_rs, z0f, z_new)
            g_new = torch.where(do_rs, g0f, g_new)
            gn = torch.where(do_rs, gn0, gn)
            status_k = torch.where(do_rs, code, gs.status)
        trace[k] = gn
        tape_record(tape, k, live, gn, s_norm, torch.clamp(mem.count, max=m),
                    status=status_k)
        done = gn < cfg.tol
        z, gz = z_new, g_new
        k += 1

    final_gn = torch.linalg.vector_norm(gz)
    if cfg.guard:
        final_gn = torch.where(gs.sick, torch.full_like(final_gn,
                                                        float("inf")),
                               final_gn)
    return LBFGSResult(z, mem, final_gn, k, done, trace, tape,
                       _exit_status(done, gs))
