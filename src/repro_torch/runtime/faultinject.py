"""Deterministic numerical-fault injection for chaos testing.

The port of ``repro/runtime/faultinject.py``.  Every containment path (the
solvers' guard and sticky statuses, the backward's zeroed rows, the
trainer's update skip, the serving loop's cold retry and poisoned-prefix
eviction) is driven by faults at known (sample, iteration) coordinates:

  * **In-solver faults** -- :func:`arm` installs :func:`_perturb` as
    ``core/solvers._FAULT_HOOK``: while a :class:`FaultPlan` is armed, every
    batched solver perturbs its post-step iterate at the planned
    coordinates.  Unarmed, the hook is ``None`` and a solver iteration pays
    one ``is not None`` test: no launch and no host read.  The iteration
    counter is the loop's Python int, so whether the fault fires is decided
    on the host; the row mask is built on the iterate's device.
  * **Host-state corruption** -- :func:`corrupt_carry_ring` poisons a
    ``SolveCarry`` quasi-Newton ring with NaNs (the corrupted-ring class);
    :func:`poison_prefix_entry` / :func:`poison_prefix_store_slot` overwrite
    a prefix-cache entry's equilibrium snapshot so the next seeded prefill
    consumes it (the poisoned-cache class).  They are duck-typed: they
    import nothing of the layers they poison.

There is no randomness anywhere in this module.
"""

from __future__ import annotations

import dataclasses

import torch

_KINDS = ("nonfinite", "stall", "diverge")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic in-solver fault.

    ``kind``      "nonfinite" (the iterate row becomes NaN), "stall" (the
                  row's step is forced to exactly zero) or "diverge" (the row
                  is scaled by ``scale``, finite, past the divergence ratio).
    ``sample``    batch row to corrupt.
    ``step``      first solver iteration (0-based) at which the fault fires.
    ``duration``  consecutive iterations the fault persists (default:
                  forever).
    ``scale``     "diverge" blow-up factor per fired iteration.
    """

    kind: str
    sample: int = 0
    step: int = 2
    duration: int = 1_000_000
    scale: float = 1e6

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")


_PLAN: FaultPlan | None = None


def current_plan() -> FaultPlan | None:
    return _PLAN


def _perturb(z_new: torch.Tensor, k: int,
             z_prev: torch.Tensor) -> torch.Tensor:
    """The solvers' hook: corrupt row ``plan.sample`` of the post-step
    iterate at iterations ``[step, step + duration)``; ``z_prev`` (the
    pre-step iterate) is the "stall" target."""
    plan = _PLAN
    if plan is None or not plan.step <= k < plan.step + plan.duration:
        return z_new
    bsz = z_new.shape[0]
    row = torch.arange(bsz, device=z_new.device) == plan.sample
    mask = row.reshape((bsz,) + (1,) * (z_new.dim() - 1))
    if plan.kind == "nonfinite":
        bad = torch.full_like(z_new, float("nan"))
    elif plan.kind == "stall":
        bad = z_prev
    else:  # diverge: finite blow-up, caught by the divergence-ratio guard
        bad = (z_new.float() * plan.scale).to(z_new.dtype)
    return torch.where(mask, bad, z_new)


def arm(plan: FaultPlan) -> None:
    """Install ``plan`` as the active in-solver fault."""
    global _PLAN
    from repro_torch.core import solvers as _solvers
    _PLAN = plan
    _solvers._FAULT_HOOK = _perturb


def disarm() -> None:
    global _PLAN
    from repro_torch.core import solvers as _solvers
    _PLAN = None
    _solvers._FAULT_HOOK = None


class inject:
    """Context manager: arm ``plan`` for the duration of the block."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        arm(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        disarm()


# ---------------------------------------------------------------------------
# Host-state corruption (duck-typed mutators)
# ---------------------------------------------------------------------------


def corrupt_carry_ring(carry, rows):
    """Return ``carry`` with the quasi-Newton U-ring of ``rows`` poisoned
    with NaNs, a nonzero ring count and ``warm=True``, so that the next
    solve consumes the corrupted inverse estimate and must detect and
    recover.  New buffers: ``carry`` itself is left as it was."""
    lr = carry.lowrank
    dev = lr.u.device
    rows = torch.as_tensor(rows, dtype=torch.int64).reshape(-1).to(dev)
    u = lr.u.clone()
    u[:, rows] = float("nan")
    count = lr.count.clone()
    count[rows] = torch.clamp(count[rows], min=1)
    warm = carry.warm.clone()
    warm[rows] = True
    return dataclasses.replace(
        carry, lowrank=dataclasses.replace(lr, u=u, count=count), warm=warm)


def poison_prefix_entry(index, key=None, value: float = float("nan")):
    """Poison one host-side ``PrefixCarryIndex`` entry's equilibrium
    snapshot in place (``key=None``: every entry).  The next prefill that
    seeds from it starts its solve at ``value``.  Returns the poisoned
    keys."""
    keys = [key] if key is not None else list(index._entries)
    for k in keys:
        e = index._entries[k]
        e.z = torch.full_like(e.z, value)
    return keys


def poison_prefix_store_slot(store, slot: int, value: float = float("nan")):
    """Poison one ``DevicePrefixStore`` slot's equilibrium rows in place
    (a ``fill_`` on the card: no host read)."""
    store.z[slot].fill_(value)
    return slot
