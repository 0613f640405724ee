"""Batched fixed-point engine for serving: per-sample-masked solves and the
per-slot carry cache.

The port of ``batched_solve``, ``write_carry_rows`` and ``CarryCache`` from
``repro/implicit/engine.py``.  ``batched_solve`` runs the registered
forward solver once over a batch whose invalid (padding / finished) slots
are frozen at entry: they consume no iterations and no quasi-Newton memory,
return their input bit for bit, and the whole-batch early exit fires as
soon as every live slot has converged.  The cross-request prefix caches
come with a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.core.lowrank import LowRank, _expand
from repro_torch.core.solvers import SolveCarry, reset_carry_rows
from repro_torch.device import to_device
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.fixed_point import (
    ImplicitStats,
    _flatten,
    solve_forward,
)
from repro_torch.implicit.pytree import prepare_flat_problem
from repro_torch.obs import metrics as obs_metrics


def batched_solve(
    f: Callable[[Any, Any, torch.Tensor], torch.Tensor],
    params: Any,
    x: Any,
    z0: torch.Tensor,
    cfg: ImplicitConfig,
    *,
    valid: torch.Tensor | None = None,
    carry: SolveCarry | None = None,
):
    """One batched forward solve of ``z = f(params, x, z)`` (inference).

    ``valid: (B,) bool`` marks live samples; the rest are frozen at ``z0``
    (returned untouched).  ``carry`` warm-starts per slot and turns the
    return into ``(z, stats, new_carry)``; frozen slots keep their carry
    rows' iterate and ring (they neither move nor age)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in _flatten((params, x, z0))[0]):
        raise ValueError("batched_solve is the inference engine and has no "
                         "backward; differentiate through "
                         "implicit_fixed_point")
    z0_flat, unravel, f_flat = prepare_flat_problem(f, z0)
    freeze = None if valid is None else ~valid
    with torch.no_grad():
        res = solve_forward(lambda z: f_flat(params, x, z), z0_flat, cfg,
                            freeze_mask=freeze, carry=carry)
    z = res.z
    if valid is not None:
        # padding/finished slots return their input state bit for bit
        z = torch.where(_expand(valid, z), z, z0_flat)
    stats = ImplicitStats(res.residual, res.n_steps, res.converged,
                          res.trace, res.tape, res.status)
    obs_metrics.record_solve("serve", res, carry=carry)
    if carry is None:
        return unravel(z), stats
    return unravel(z), stats, res.carry


def write_carry_rows(dst: SolveCarry, src: SolveCarry,
                     slots: Sequence[int], rows: Sequence[int]) -> SolveCarry:
    """Copy batch rows ``rows`` of ``src`` into batch slots ``slots`` of
    ``dst`` (every field; the ring scatters along its batch axis 1), in
    place: ``dst``'s buffers are updated and a carry sharing them is
    returned."""
    dev = dst.z.device
    sl = to_device(torch.as_tensor(list(slots), dtype=torch.long), dev)
    rw = to_device(torch.as_tensor(list(rows), dtype=torch.long), dev)
    lr_d, lr_s = dst.lowrank, src.lowrank
    dst.z[sl] = src.z[rw].to(dst.z.dtype)
    lr_d.u[:, sl] = lr_s.u[:, rw].to(lr_d.u.dtype)
    lr_d.v[:, sl] = lr_s.v[:, rw].to(lr_d.v.dtype)
    count = lr_d.count.clone()
    count[sl] = lr_s.count[rw]
    warm = dst.warm.clone()
    warm[sl] = src.warm[rw]
    age = dst.age.clone()
    age[sl] = src.age[rw]
    return SolveCarry(
        z=dst.z,
        lowrank=LowRank(alpha=lr_d.alpha, u=lr_d.u, v=lr_d.v, count=count),
        warm=warm, age=age)


class CarryCache:
    """Host-side per-slot :class:`SolveCarry` store for the serving engine.

    Each fixed batch slot owns one carry row, keyed by the request id
    leased to it.  ``lease`` binds a slot and evicts the previous occupant's
    state (a recycled slot never warm-starts from a stranger's
    equilibrium); ``release`` evicts when a request completes.
    ``max_age`` bounds how many solves a row may accumulate before
    ``update`` resets it to cold.  Every eviction is counted by reason
    (``evictions_by_reason`` and the registry counter
    ``carry_evictions_total{reason}``).
    """

    def __init__(self, make_cold: Callable[[], SolveCarry], slots: int, *,
                 max_age: int | None = None):
        self.slots = slots
        self.max_age = max_age
        self._owner: list[Any] = [None] * slots
        self.carry: SolveCarry = make_cold()
        self.evictions = 0
        self.evictions_by_reason = {"ownership": 0, "release": 0, "stale": 0}
        if self.carry.z.shape[0] != slots:
            raise ValueError(
                f"cold carry has batch {self.carry.z.shape[0]} for "
                f"{slots} slots")
        if max_age is not None and max_age < 1:
            raise ValueError(f"max_age must be >= 1, got {max_age}")

    def _count(self, reason: str, n: int = 1) -> None:
        self.evictions += n
        self.evictions_by_reason[reason] += n
        obs_metrics.default_registry().counter(
            "carry_evictions_total", {"reason": reason}).inc(n)

    def _reset(self, slot: int, reason: str = "ownership") -> None:
        mask = torch.arange(self.slots, device=self.carry.z.device) == slot
        self.carry = reset_carry_rows(self.carry, mask)
        self._count(reason)

    def lease(self, slot: int, request_id: Any, *,
              reset: bool = True) -> None:
        """Bind ``slot`` to ``request_id``, evicting any previous occupant;
        ``reset=False`` skips the cold reset for callers about to overwrite
        every field of the row."""
        if self._owner[slot] == request_id and request_id is not None:
            return
        self._owner[slot] = request_id
        if reset:
            self._reset(slot)
        else:
            self._count("ownership")

    def release(self, slot: int) -> None:
        """Request finished: free the slot and evict its carry."""
        self._owner[slot] = None
        self._reset(slot, reason="release")

    def owner(self, slot: int) -> Any:
        return self._owner[slot]

    def update(self, carry: SolveCarry) -> None:
        """Adopt the post-solve carry, then reset rows older than
        ``max_age`` to cold."""
        self.carry = carry
        if self.max_age is None:
            return
        stale = carry.age > self.max_age
        n = int(stale.sum())
        if n:
            self.carry = reset_carry_rows(self.carry, stale)
            self._count("stale", n)
