"""Batched fixed-point engine for serving: per-sample-masked solves, the
per-slot carry cache and the cross-request prefix caches.

The port of ``repro/implicit/engine.py``:

  * ``coalesce_states`` packs a ragged list of per-request states into one
    fixed-slot batch (padding repeats request 0 and is marked invalid);
  * ``batched_solve`` runs the registered forward solver once over a batch
    whose invalid (padding / finished) slots are frozen at entry: they
    consume no iterations and no quasi-Newton memory, return their input
    bit for bit, and the whole-batch early exit fires as soon as every live
    slot has converged;
  * ``CarryCache`` owns the serving loop's per-slot solve state;
  * ``PrefixCarryIndex`` (host snapshots) and ``DevicePrefixStore``
    (preallocated slot tensors on the loop's device, host bookkeeping over
    ints only) cache converged prefill carries across requests, keyed by
    rolling hashes of the token prefix (``prefix_hashes``);
    ``prefix_store_scatter`` publishes a wave's carries into the store in
    place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.core.lowrank import LowRank, _expand
from repro_torch.core.solvers import SolveCarry, reset_carry_rows, torch_dtype
from repro_torch.device import to_device
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.fixed_point import (
    ImplicitStats,
    SolveLayout,
    _flatten,
    solve_forward,
)
from repro_torch.implicit.pytree import prepare_flat_problem
from repro_torch.obs import metrics as obs_metrics


class CoalescedBatch(NamedTuple):
    """A wave of requests packed into one fixed-slot solver batch."""

    z0: Any           # (slots, ...) stacked initial states
    valid: torch.Tensor  # (slots,) bool -- False for padding slots
    unbatch: Callable[[Any], list]  # batch -> per-request states


def coalesce_states(states: list, slots: int | None = None) -> CoalescedBatch:
    """Stack per-request state trees (tensors without a batch dim, in
    dicts, lists or tuples) into one batch.  ``slots`` pads the batch to a
    fixed size; padding repeats request 0 and is marked invalid, so the
    solver freezes it at entry."""
    if not states:
        raise ValueError("coalesce_states needs at least one request")
    n = len(states)
    slots = n if slots is None else slots
    if slots < n:
        raise ValueError(f"{n} requests do not fit {slots} slots")
    padded = list(states) + [states[0]] * (slots - n)
    flat = [_flatten(s) for s in padded]
    rebuild = flat[0][1]
    z0 = rebuild([torch.stack(leaves)
                  for leaves in zip(*(f[0] for f in flat))])
    first = flat[0][0][0]
    valid = torch.arange(slots, device=first.device) < n

    def unbatch(z) -> list:
        leaves, rb = _flatten(z)
        return [rb([a[i] for a in leaves]) for i in range(n)]

    return CoalescedBatch(z0=z0, valid=valid, unbatch=unbatch)


def batched_solve(
    f: Callable[[Any, Any, torch.Tensor], torch.Tensor],
    params: Any,
    x: Any,
    z0: torch.Tensor,
    cfg: ImplicitConfig,
    *,
    valid: torch.Tensor | None = None,
    carry: SolveCarry | None = None,
    ctx=None,
    state_axes=None,
):
    """One batched forward solve of ``z = f(params, x, z)`` (inference).

    ``valid: (B,) bool`` marks live samples; the rest are frozen at ``z0``
    (returned untouched).  ``carry`` warm-starts per slot and turns the
    return into ``(z, stats, new_carry)``; frozen slots keep their carry
    rows' iterate and ring (they neither move nor age).  ``ctx`` and
    ``state_axes`` lay the solve out on a running mesh, as
    ``implicit_fixed_point``'s do."""
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
                            freeze_mask=freeze, carry=carry,
                            layout=SolveLayout.make(ctx, state_axes,
                                                    z0_flat))
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


def _index(idx, dev: torch.device) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=dev, dtype=torch.long)
    return to_device(torch.as_tensor(list(idx), dtype=torch.long), dev)


def write_carry_rows(dst: SolveCarry, src: SolveCarry,
                     slots: Sequence[int], rows: Sequence[int]) -> SolveCarry:
    """Copy batch rows ``rows`` of ``src`` into batch slots ``slots`` of
    ``dst`` (every field; the ring scatters along its batch axis 1), in
    place: ``dst``'s buffers are updated and a carry sharing them is
    returned.  ``slots``/``rows`` are ints or index tensors (on the card,
    a tensor already there costs no copy)."""
    dev = dst.z.device
    sl, rw = _index(slots, dev), _index(rows, dev)
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


def write_carry_slot(dst: SolveCarry, src: SolveCarry, slot: int,
                     row: int) -> SolveCarry:
    """Single-request view of :func:`write_carry_rows`."""
    return write_carry_rows(dst, src, (slot,), (row,))


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


# ---------------------------------------------------------------------------
# Cross-request prefix carry cache (the prefix-cache analogue of CarryCache)
# ---------------------------------------------------------------------------


_PREFIX_HASH_MOD = (1 << 61) - 1
_PREFIX_HASH_MUL = 1_000_003
_PREFIX_HASH_SEED = 7919


def prefix_hashes(tokens: Sequence[int]) -> list[int]:
    """Rolling (polynomial) hashes of every prefix of ``tokens``:
    ``out[k]`` covers ``tokens[:k]`` (``out[0]`` is the empty-prefix seed),
    so a longest-prefix match probes one dict key per stored length."""
    out = [_PREFIX_HASH_SEED]
    acc = _PREFIX_HASH_SEED
    for t in tokens:
        acc = (acc * _PREFIX_HASH_MUL + int(t) + 1) % _PREFIX_HASH_MOD
        out.append(acc)
    return out


def _boundaries(n: int, block: int) -> list[int]:
    """Publication lengths of an ``n``-token prompt: every multiple of
    ``block`` below ``n``, and ``n``."""
    return sorted({min(block * k, n) for k in range(1, n // block + 2)}
                  | {n})


def _check_cache_args(slots: int, block: int, max_age: int | None) -> None:
    if slots < 0:
        raise ValueError(f"slots must be >= 0, got {slots}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if max_age is not None and max_age < 1:
        raise ValueError(f"max_age must be >= 1, got {max_age}")


def _chain(entries: dict, tokens: Sequence[int],
           longest_first: bool) -> list[tuple[int, int, Any]]:
    """``(length, key, entry)`` of every entry of ``entries`` (hash key ->
    entry with ``tokens``) on the prefix chain of ``tokens``."""
    toks = tuple(int(t) for t in tokens)
    hashes = prefix_hashes(toks)
    out = []
    for L in sorted({e.length for e in entries.values()},
                    reverse=longest_first):
        if L > len(toks):
            continue
        e = entries.get(hashes[L])
        if e is not None and e.tokens == toks[:L]:
            out.append((L, hashes[L], e))
    return out


def _count_eviction(reason: str) -> None:
    obs_metrics.default_registry().counter(
        "prefix_cache_evictions_total", {"reason": reason}).inc()


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: the solve carry snapshot at a token boundary.

    ``z`` is the ``(L, *feat)`` equilibrium over the prefix positions,
    ``u``/``v`` the donor's ring over the same positions (``(m, L,
    *feat)``) with ``count`` valid slots.  Host (CPU) tensors: the index
    holds no device memory."""

    tokens: tuple[int, ...]
    z: Any
    u: Any
    v: Any
    count: int
    born: int        # index clock at (re)publication: staleness anchor
    last_used: int   # index clock at last lease/publication: LRU anchor
    refs: int = 0    # in-flight leases; a leased entry is never evicted
    hits: int = 0

    @property
    def length(self) -> int:
        return len(self.tokens)


class PrefixMatch(NamedTuple):
    """A leased lookup result: return it with ``PrefixCarryIndex.release``."""

    entry: PrefixEntry
    length: int   # matched prefix length (== entry.length)
    exact: bool   # the whole prompt matched (full hit vs partial hit)


class PrefixCarryIndex:
    """Host-side cross-request prefix cache of solve-carry snapshots (the
    sync pipeline's).

    Two prompts sharing a token prefix converge (causally) to the same
    prefix equilibrium, so one prefill's converged carry (iterate and qN
    ring) warm-starts another's.  Entries are keyed by the rolling hash of
    the prefix and stored at ``block``-aligned boundaries plus the full
    prompt length; a lookup finds the longest stored prefix (the whole
    prompt = exact hit, shorter = partial hit), comparing token tuples
    against hash collisions.  Republishing a stored prefix refreshes it.

    ``slots`` bounds the entries with LRU eviction and ``max_age`` the
    index operations an entry survives without republication; leased
    entries are never evicted (capacity may overflow until release).
    Evictions count in ``evictions_by_reason`` and on
    ``prefix_cache_evictions_total{reason=lru|stale|poisoned}``; occupancy
    on the ``prefix_cache_entries``/``prefix_cache_tokens`` gauges.
    """

    def __init__(self, slots: int = 32, *, block: int = 4,
                 max_age: int | None = None):
        _check_cache_args(slots, block, max_age)
        self.slots = slots
        self.block = block
        self.max_age = max_age
        self._entries: dict[int, PrefixEntry] = {}
        self._clock = 0
        self.published = 0
        self.lookups = 0
        self.hits = 0
        self.evictions_by_reason = {"lru": 0, "stale": 0, "poisoned": 0}

    # -- bookkeeping ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def tokens_held(self) -> int:
        return sum(e.length for e in self._entries.values())

    def stats(self) -> dict:
        return {"entries": len(self), "tokens": self.tokens_held(),
                "published": self.published, "lookups": self.lookups,
                "hits": self.hits, "evictions": dict(self.evictions_by_reason)}

    def _publish_gauges(self) -> None:
        obs_metrics.record_prefix_occupancy(len(self), self.tokens_held())

    def _evict(self, key: int, reason: str) -> None:
        del self._entries[key]
        self.evictions_by_reason[reason] += 1
        _count_eviction(reason)

    def _sweep_stale(self) -> None:
        if self.max_age is None:
            return
        stale = [k for k, e in self._entries.items()
                 if e.refs == 0 and self._clock - e.born > self.max_age]
        for k in stale:
            self._evict(k, "stale")

    def _evict_lru(self) -> None:
        while len(self._entries) > self.slots:
            victims = [(e.last_used, k) for k, e in self._entries.items()
                       if e.refs == 0]
            if not victims:
                return  # everything leased: transient overflow
            self._evict(min(victims)[1], "lru")

    # -- the cache interface -------------------------------------------

    def publish(self, tokens: Sequence[int], z, u=None, v=None,
                count: int = 0) -> int:
        """Store a completed prefill's carry for ``tokens``: ``z (L,
        *feat)``, and the ring ``u``/``v (m, L, *feat)`` with ``count``
        valid slots (``None`` stores an iterate-only entry), sliced at
        every boundary: the entries are views of the given tensors, which
        one snapshot's boundaries share.  Returns the number of new
        entries."""
        self._clock += 1
        self._sweep_stale()
        n = len(tokens)
        if n == 0:
            return 0
        toks = tuple(int(t) for t in tokens)
        hashes = prefix_hashes(toks)
        ring = u is not None and v is not None and count > 0
        created = 0
        for L in _boundaries(n, self.block):
            key = hashes[L]
            e = self._entries.get(key)
            if e is not None and e.tokens == toks[:L]:
                # dedup: refresh the existing entry instead of re-slicing
                e.born = e.last_used = self._clock
                continue
            self._entries[key] = PrefixEntry(
                tokens=toks[:L], z=torch.as_tensor(z)[:L],
                u=torch.as_tensor(u)[:, :L] if ring else None,
                v=torch.as_tensor(v)[:, :L] if ring else None,
                count=int(count) if ring else 0,
                born=self._clock, last_used=self._clock)
            created += 1
        self.published += 1
        self._evict_lru()
        self._publish_gauges()
        return created

    def lookup(self, tokens: Sequence[int]) -> PrefixMatch | None:
        """Longest-prefix match for ``tokens``; leases the entry (its ref
        count protects it from eviction) until ``release``."""
        self._clock += 1
        self._sweep_stale()
        self.lookups += 1
        for L, _key, e in _chain(self._entries, tokens, True):
            e.refs += 1
            e.hits += 1
            e.last_used = self._clock
            self.hits += 1
            return PrefixMatch(entry=e, length=L, exact=L == len(tokens))
        return None

    def release(self, match: PrefixMatch | PrefixEntry) -> None:
        """Return a lease taken by ``lookup`` (exactly once per lease)."""
        e = match.entry if isinstance(match, PrefixMatch) else match
        if e.refs <= 0:
            raise ValueError("release without a matching lookup lease")
        e.refs -= 1
        self._evict_lru()
        self._publish_gauges()

    def evict_poisoned(self, tokens: Sequence[int]) -> int:
        """Drop every entry on ``tokens``'s prefix chain (a solve seeded
        from it faulted), leased or not; counts under
        ``prefix_cache_evictions_total{reason="poisoned"}``.  Returns the
        number dropped."""
        chain = _chain(self._entries, tokens, False)
        for _L, key, _e in chain:
            self._evict(key, "poisoned")
        self._publish_gauges()
        return len(chain)


# ---------------------------------------------------------------------------
# Device-resident prefix carry store (the async pipeline's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DevEntry:
    """Host bookkeeping for one stored prefix: which device row holds the
    donor and how many leading tokens of it this entry covers."""

    tokens: tuple[int, ...]
    slot: int
    born: int
    last_used: int
    hits: int = 0

    @property
    def length(self) -> int:
        return len(self.tokens)


class DevPrefixMatch(NamedTuple):
    """A store lookup: gather row ``slot``'s first ``length`` positions on
    the device; the host only learns ints."""

    slot: int
    length: int
    exact: bool


class DevicePrefixStore:
    """Cross-request prefix carry cache with its payload on the device.

    Preallocated slot tensors on ``device``: ``z (slots+1, seq, *feat)``,
    ``u``/``v (m, slots+1, seq, *feat)`` in the ring dtype and ``count
    (slots+1,)``.  Row ``slots`` is a scratch row: a publish the host
    decides to skip (a dedup refresh) scatters there, so a wave's scatter
    never depends on the decision.  :meth:`lookup` returns a donor row id
    for a gather (``lm.prefix_gather_carry``); :meth:`plan_publish` picks
    the row a wave's converged carry is written to
    (:func:`prefix_store_scatter`, in place).  Stream order keeps readers
    and writers apart: a wave gathers before it scatters, and a later
    wave's gather runs after every earlier scatter.

    Only the rolling-hash / longest-prefix-match / LRU bookkeeping is on
    the host, over ints.  Eviction mirrors :class:`PrefixCarryIndex` (LRU
    over rows, ``max_age`` sweeps by the operation clock, the same
    counters and gauges)."""

    def __init__(self, slots: int, seq: int, feat: tuple[int, ...] | int,
                 memory: int, *, block: int = 4, max_age: int | None = None,
                 dtype=torch.float32, qn_dtype="bfloat16", device="cpu"):
        _check_cache_args(slots, block, max_age)
        if seq < 1:
            raise ValueError(f"seq must be >= 1, got {seq}")
        feat = (feat,) if isinstance(feat, int) else tuple(feat)
        ring = torch_dtype(qn_dtype) if qn_dtype is not None else dtype
        self.slots, self.seq, self.block = slots, seq, block
        self.memory = memory
        self.max_age = max_age
        self.scratch = slots  # the throw-away row
        n = slots + 1
        self.z = torch.zeros((n, seq) + feat, dtype=dtype, device=device)
        self.u = torch.zeros((memory, n, seq) + feat, dtype=ring,
                             device=device)
        self.v = torch.zeros_like(self.u)
        self.count = torch.zeros((n,), dtype=torch.int32, device=device)
        # hash -> entry, per-row reverse index and LRU clock
        self._entries: dict[int, DevEntry] = {}
        self._slot_keys: list[set[int]] = [set() for _ in range(slots)]
        self._slot_used: list[int] = [0] * slots
        self._free: list[int] = list(range(slots))
        self._clock = 0
        self.published = 0
        self.lookups = 0
        self.hits = 0
        self.evictions_by_reason = {"lru": 0, "stale": 0, "poisoned": 0}

    # -- device side ----------------------------------------------------

    @property
    def arrays(self) -> tuple[torch.Tensor, ...]:
        """The slot tensors ``(z, u, v, count)``."""
        return (self.z, self.u, self.v, self.count)

    def adopt(self, arrays) -> None:
        """Take ``arrays`` as the slot tensors."""
        self.z, self.u, self.v, self.count = arrays

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays)

    # -- bookkeeping ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def tokens_held(self) -> int:
        return sum(e.length for e in self._entries.values())

    def stats(self) -> dict:
        return {"entries": len(self), "tokens": self.tokens_held(),
                "published": self.published, "lookups": self.lookups,
                "hits": self.hits, "evictions": dict(self.evictions_by_reason)}

    def _publish_gauges(self) -> None:
        obs_metrics.record_prefix_occupancy(len(self), self.tokens_held())

    def _drop_key(self, key: int, reason: str) -> None:
        e = self._entries.pop(key)
        self.evictions_by_reason[reason] += 1
        _count_eviction(reason)
        ks = self._slot_keys[e.slot]
        ks.discard(key)
        if not ks:
            self._free.append(e.slot)

    def _sweep_stale(self) -> None:
        if self.max_age is None:
            return
        stale = [k for k, e in self._entries.items()
                 if self._clock - e.born > self.max_age]
        for k in stale:
            self._drop_key(k, "stale")

    def _take_slot(self) -> int:
        """A free device row, evicting the LRU row's entries if needed."""
        if self._free:
            return self._free.pop()
        victim = min((u, s) for s, u in enumerate(self._slot_used)
                     if self._slot_keys[s])[1]
        for k in list(self._slot_keys[victim]):
            self._drop_key(k, "lru")
        return self._free.pop()

    # -- the cache interface ----------------------------------------------

    def peek(self, tokens: Sequence[int]) -> tuple[int, int] | None:
        """Side-effect-free longest-prefix probe: ``(hash_key, length)`` of
        the longest stored prefix, or None (admission reordering)."""
        for L, key, _e in _chain(self._entries, tokens, True):
            return key, L
        return None

    def lookup(self, tokens: Sequence[int]) -> DevPrefixMatch | None:
        """Longest-prefix match: the donor row id for a gather.  No lease:
        stream order protects in-flight readers."""
        self._clock += 1
        self._sweep_stale()
        self.lookups += 1
        for L, _key, e in _chain(self._entries, tokens, True):
            e.hits += 1
            e.last_used = self._clock
            self._slot_used[e.slot] = self._clock
            self.hits += 1
            return DevPrefixMatch(slot=e.slot, length=L,
                                  exact=L == len(tokens))
        return None

    def plan_publish(self, tokens: Sequence[int]) -> int:
        """Pick the device row this prompt's converged carry is scattered
        to, creating or refreshing the host entries at every boundary.
        Returns the scratch row when nothing new needs storing (dedup
        refresh, empty or oversized prompt, no capacity)."""
        self._clock += 1
        self._sweep_stale()
        n = len(tokens)
        if n == 0 or n > self.seq or self.slots == 0:
            return self.scratch
        toks = tuple(int(t) for t in tokens)
        hashes = prefix_hashes(toks)
        full = self._entries.get(hashes[n])
        if full is not None and full.tokens == toks:
            # the whole chain is on the device: refresh the clocks only
            for L in _boundaries(n, self.block):
                e = self._entries.get(hashes[L])
                if e is not None and e.tokens == toks[:L]:
                    e.born = e.last_used = self._clock
                    self._slot_used[e.slot] = self._clock
            self.published += 1
            return self.scratch
        slot = self._take_slot()
        self._slot_used[slot] = self._clock
        created = False
        for L in _boundaries(n, self.block):
            key = hashes[L]
            e = self._entries.get(key)
            if e is not None and e.tokens == toks[:L]:
                e.born = e.last_used = self._clock
                continue
            if e is not None:
                # hash collision with different tokens: replace
                self._drop_key(key, "lru")
            self._entries[key] = DevEntry(tokens=toks[:L], slot=slot,
                                          born=self._clock,
                                          last_used=self._clock)
            self._slot_keys[slot].add(key)
            created = True
        if not created:
            # every boundary was already covered by other donors
            self._free.append(slot)
            slot = self.scratch
        self.published += 1
        self._publish_gauges()
        return slot

    def evict_poisoned(self, tokens: Sequence[int]) -> int:
        """Drop every host entry on ``tokens``'s prefix chain (their rows
        become unreachable and are recycled); counts under
        ``prefix_cache_evictions_total{reason="poisoned"}``."""
        chain = _chain(self._entries, tokens, False)
        for _L, key, _e in chain:
            self._drop_key(key, "poisoned")
        self._publish_gauges()
        return len(chain)


def prefix_store_scatter(arrays, carry: SolveCarry,
                         slot_ids: torch.Tensor) -> None:
    """Publish a converged prefill wave's carry rows into the store's slot
    tensors, in place (``index_copy_`` along the row axis).  ``slot_ids
    (B,)`` may point rows at the scratch row to skip publication."""
    z_s, u_s, v_s, c_s = arrays
    seq = carry.z.shape[1]
    lr = carry.lowrank
    idx = slot_ids.to(device=z_s.device, dtype=torch.long)
    z_s.narrow(1, 0, seq).index_copy_(0, idx, carry.z.to(z_s.dtype))
    u_s.narrow(2, 0, seq).index_copy_(1, idx, lr.u.to(u_s.dtype))
    v_s.narrow(2, 0, seq).index_copy_(1, idx, lr.v.to(v_s.dtype))
    c_s.index_copy_(0, idx, lr.count.to(c_s.dtype))
