"""Batched serving loop: fixed-slot continuous batching over prefill/decode.

The port of ``repro/runtime/serving.py``.  A ``ServeLoop`` owns B slots;
requests are admitted into free slots, prefilled into the slot's cache
rows, and decoded one token per tick for every active slot (inactive
slots masked) until EOS or ``max_new_tokens``:

  * **Request coalescing** -- admission groups the wave's prompts by length
    and prefills each group in one batched call.
  * **Per-sample convergence masking** -- the active-slot mask is passed to
    ``decode_step``; the DEQ solve freezes inactive slots and exits as soon
    as every live slot converges.
  * **Persistent solve state** (DEQ models) -- each slot owns a
    :class:`~repro_torch.implicit.CarryCache` row: the equilibrium and qN
    ring at token *t* warm-start token *t+1*, the prefill's last-token
    equilibrium seeds token 0, and a recycled slot is evicted cold.
  * **Fault containment** (guarded DEQ models) -- a prefill row whose solve
    faults (DIVERGED / NONFINITE / STALLED) emits no token and is retried
    once cold, with no prefix seed, and a prefix that seeded it is evicted;
    a second fault ends the request with ``error`` set.  A faulted decode
    row keeps generating (the solver already restarted it) with the fault
    recorded on the request.
  * **Cross-request prefix cache** (``prefix_cache=True``, DEQ models; a
    no-op otherwise, as in the reference) -- a prefill
    solve starts from the converged carry (equilibrium and the solve's own
    qN ring) of the longest cached prefix of its prompt, and publishes its
    own; iterations spent and saved against the cold reference of the same
    ``(prompt length, wave)`` are counted (``prefill_iters``,
    ``saved_iters``).
  * **Admission reordering** (``reorder=True``) -- queued requests are
    stable-sorted so prompts sharing a cached prefix land in one wave; a
    request passed over more than ``reorder_age_bound`` rounds goes first.

Pipelines (``pipeline=``):

  * ``"sync"`` -- each wave and tick blocks on its result: the host picks
    tokens with ``argmax``, read together with the row statuses and what
    the metrics bridge holds in one transfer.  The prefix cache is the
    host-side :class:`~repro_torch.implicit.PrefixCarryIndex`, whose
    snapshots travel through host memory.
  * ``"async"`` (the launcher's default, as in the reference) -- the slot
    lifecycle (current token, lengths, active mask, emitted and allowed
    token counts) lives on the device and each tick advances it there
    (argmax, EOS / max-new mask, carry staleness reset), so dispatching
    tick *t+1* never needs tick *t*'s results.  Each wave's and tick's
    small outputs are copied into pinned host buffers without a wait, an
    event is recorded after the copies, and the entry joins a completion
    queue; it lands once the event has completed (``Event.query()``), so
    landing reads host memory only.  When ``async_depth`` entries are in
    flight the loop polls the oldest (a ``pipeline_wait`` span), it does
    not block on the card.  The prefix cache is the
    :class:`~repro_torch.implicit.DevicePrefixStore`: lookup is a gather
    by row id and publication an in-place scatter, so snapshots never
    leave the card.  TTFT stays exact: a drain waits once for a timing
    event to pin the card's clock to the wall clock, and each entry's
    stamp is that wall time plus the card's time between the two events.
    The solvers still read the card twice per iteration, so dispatch
    blocks inside every solve; the pipeline overlaps what follows it.  On
    the CPU every entry is ready when it is queued.

A layer-stack model (``cfg.deq.enabled`` false) has no solve state: no
carries, no prefix cache, no fault containment, and its step counts are
0.  The caches are written into their slots leaf by leaf, each at its
batch axis, probed once from the cache shapes as the reference probes it.

Every host read of data the card has not finished counts on
``host_syncs_total{site}``; the async steady state records none.  With
tracing on, a sync drain is a ``drain`` span over ``serve_tick`` spans,
each holding ``admit`` (a ``prefill`` span per prompt length) and
``decode``; an async drain holds ``admit``, ``prefill_dispatch``,
``decode_dispatch`` and ``pipeline_wait`` spans, and the gauge
``serve_pipeline_inflight`` follows the completion queue.

On a mesh (``ctx``: a running ``ShardCtx``, ``DECODE_RULES``; prefill
under ``prefill_ctx``, ``PREFILL_RULES``) the sync pipeline runs on every
rank: the parameters and the slot caches are DTensors (the slots split
over "data", the cache length over "model"), each data rank prefills the
whole wave (a wave rarely divides over the DP axes), a prefilled row is written
into the ranks that hold its slot (``_write_slot``), the logits, statuses
and the DEQ carry come back whole (the same on every rank, so every rank
emits the same tokens), and each solve runs batch-split
(``implicit/engine.batched_solve``).  The async pipeline and the prefix
caches under a mesh raise.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import time
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.core.solvers import (
    STATUS_DIVERGED,
    STATUS_NAMES,
    reset_carry_rows,
)
from repro_torch.device import to_device
from repro_torch.implicit.engine import (
    CarryCache,
    DevicePrefixStore,
    PrefixCarryIndex,
    prefix_hashes,
    prefix_store_scatter,
    write_carry_rows,
)
from repro_torch.models import lm
from repro_torch.models.layers import act_dtype
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.parallel.sharding import NULL_CTX, ShardCtx, full_tree

# how long the async loop sleeps between polls of an entry it waits for
_POLL_S = 5e-5


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # wall time the request entered the queue; TTFT = first token - submit
    t_submit: float = 0.0
    # admission rounds spent queued (reorder fairness accounting)
    wait_rounds: int = 0
    # solve-health name when this request's own solve faulted; a faulted
    # prefill is retried once cold (``retried`` marks the retry spent);
    # ``epoch`` versions the async pipeline's in-flight entries, so landings
    # from before a retry are dropped
    error: str | None = None
    retried: bool = False
    epoch: int = 0


@dataclasses.dataclass
class _Inflight:
    """One dispatched wave or tick on the completion queue."""

    kind: str                       # "prefill" | "tick"
    group: list[tuple[int, Any]]    # (slot, Request) at dispatch
    host: dict[str, torch.Tensor]   # host copies of the small outputs
    event: Any                      # CUDA event after the copies; None: ready
    t_dispatch: float
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    # the metrics bridge's pending values, as host copies: (land, tensors)
    metrics: list = dataclasses.field(default_factory=list)


class ServeLoop:
    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, eos_id: int = 1,
                 carry_max_age: int | None = None,
                 prefix_cache: bool = False, prefix_cache_slots: int = 32,
                 prefix_block: int = 4, prefix_max_age: int | None = None,
                 pipeline: str = "sync", async_depth: int = 2,
                 reorder: bool = False, reorder_age_bound: int = 8,
                 record: bool = False, ctx: ShardCtx = NULL_CTX,
                 prefill_ctx: ShardCtx | None = None):
        if pipeline not in ("sync", "async"):
            raise ValueError(f"pipeline must be sync|async, got {pipeline!r}")
        if ctx.running and (pipeline != "sync" or prefix_cache):
            raise NotImplementedError(
                "on a mesh the serving loop runs the sync pipeline without "
                "the prefix caches (the async pipeline and the prefix "
                "caches under a mesh are not ported yet)")
        self.ctx = ctx
        # a prefill wave (often one request) does not divide over the DP
        # axes: each data rank prefills the whole wave, the heads and the
        # cache length split as the prefill rules say
        pctx = prefill_ctx or ctx
        self.prefill_ctx = dataclasses.replace(
            pctx, rules=pctx.rules.replace(batch=None))
        if ctx.running and slots % ctx.axis_size("batch"):
            raise ValueError(f"slots={slots} must divide over the DP mesh "
                             f"extent {ctx.axis_size('batch')}")
        if async_depth < 1:
            raise ValueError(f"async_depth must be >= 1, got {async_depth}")
        if reorder_age_bound < 1:
            raise ValueError(
                f"reorder_age_bound must be >= 1, got {reorder_age_bound}")
        self.params, self.cfg = params, cfg
        self.device = lm.params_device(params)
        self.slots, self.max_len, self.eos = slots, max_len, eos_id
        self.pipeline = pipeline
        self.async_depth = async_depth
        self.reorder = reorder
        self.reorder_age_bound = reorder_age_bound
        self.queue: "queue.Queue[Request]" = queue.Queue()
        # admission staging list: the reorder policy stable-sorts it
        self.pending: list[Request] = []
        self.active: list[Request | None] = [None] * slots
        self.caches = lm.init_cache(cfg, slots, max_len, self.device, ctx)
        self._cache_axes = cache_batch_axes(cfg)
        self.lengths = self._zeros(torch.int32)
        self.cur_tok = self._zeros(torch.int32)
        self.prefill_calls = 0
        self.prefill_requests = 0
        self._metrics = obs_metrics.default_registry()
        # record mode (tests): per-request last-position logits and
        # per-solve step counts, as the JAX ServeLoop records them
        self._record = record
        self.recorded_logits: dict[int, list[np.ndarray]] = {}
        self.recorded_steps: dict[int, list[float]] = {}
        # every solve the loop ran: phase, live rows, steps, row statuses
        # (an async entry's statuses are filled in when it lands)
        self.solve_log: list[dict[str, Any]] = []
        deq = cfg.deq.enabled
        self.carries = CarryCache(
            lambda: lm.deq_solve_carry(cfg, slots, 1, self.device), slots,
            max_age=carry_max_age) if deq else None
        # cross-request prefix cache: host snapshots for the sync pipeline,
        # device rows for the async one.  ``prefix_cache_slots=0`` is the
        # cold accounting arm: every lookup misses, iterations still count
        self.prefix: PrefixCarryIndex | None = None
        self.prefix_store: DevicePrefixStore | None = None
        if prefix_cache and deq:
            if pipeline == "sync":
                self.prefix = PrefixCarryIndex(
                    prefix_cache_slots, block=prefix_block,
                    max_age=prefix_max_age)
            else:
                self.prefix_store = DevicePrefixStore(
                    prefix_cache_slots, max_len, (cfg.d_model,),
                    cfg.deq.memory, block=prefix_block,
                    max_age=prefix_max_age, dtype=act_dtype(cfg),
                    qn_dtype=cfg.deq.qn_dtype, device=self.device)
        # Broyden iterations spent in prefill solves (prefix path only),
        # and the cold reference per (prompt length, wave) that hit waves
        # are credited against
        self.prefill_iters = 0.0
        self.saved_iters = 0.0
        self._cold_prefill_ref: dict[tuple[int, int], float] = {}
        self._guarded = bool(deq and cfg.deq.guard)

        # -- async pipeline state -----------------------------------------
        # the slot lifecycle on the device: the tick advances it there
        self._dev_active = self._zeros(torch.bool)
        self._ntok = self._zeros(torch.int32)
        self._max_new = self._zeros(torch.int32)
        # host count of the tokens DISPATCHED per slot: max-new completion
        # is predictable, so exhausted slots get no more ticks
        self._planned = [0] * slots
        self._inflight: collections.deque[_Inflight] = collections.deque()
        # (timing event, wall time) pinning the card's clock for stamps
        self._clock0: tuple[Any, float] | None = None
        self._last_tick_stamp: float | None = None

    def _zeros(self, dtype) -> torch.Tensor:
        return torch.zeros((self.slots,), dtype=dtype, device=self.device)

    def _prefill(self, toks: torch.Tensor, n: int):
        """``lm.prefill`` of an ``n``-row wave without a prefix seed:
        ``(logits, caches, seeded carry, steps, statuses)``; the carry is
        None without the DEQ."""
        carry = (None if self.carries is None
                 else lm.deq_solve_carry(self.cfg, n, 1, self.device))
        res = lm.prefill(self.params, {"tokens": toks}, self.cfg,
                         self.max_len, carry=carry, return_steps=True,
                         return_status=True, ctx=self.prefill_ctx)
        if carry is None:
            res = res[:3] + (None,) + res[3:]
        logits, cache_new, _lens, seeded, steps, status = res
        # on a mesh: the caches stay split, the rest comes back whole
        return (full_tree(logits), cache_new, full_tree(seeded), steps,
                full_tree(status))

    def _decode(self, active: torch.Tensor):
        """``lm.decode_step`` over every slot, the caches updated in place:
        ``(logits, new carry, steps, statuses)``; the carry is None
        without the DEQ."""
        carry = None if self.carries is None else self.carries.carry
        res = lm.decode_step(self.params, self.caches, self.cur_tok,
                             self.lengths, self.cfg, active=active,
                             carry=carry, return_steps=True,
                             return_status=True, ctx=self.ctx)
        if carry is None:
            res = res[:2] + (None,) + res[2:]
        logits, self.caches, new_carry, steps, status = res
        return (full_tree(logits), full_tree(new_carry), steps,
                full_tree(status))

    def _release(self, slot: int) -> None:
        if self.carries is not None:
            self.carries.release(slot)

    def _write_slot(self, cache_new: dict, slot: int, row: int) -> None:
        """Write batch row ``row`` of ``cache_new`` into slot ``slot`` of
        the live caches, leaf by leaf at each leaf's batch axis."""
        for live, new, ax in zip(cache_leaves(self.caches),
                                 cache_leaves(cache_new), self._cache_axes):
            if ax < 0:
                continue
            if isinstance(live, DTensor):
                _write_row_sharded(live, new, ax, slot, row)
            else:
                live.narrow(ax, slot, 1).copy_(new.narrow(ax, row, 1))

    # -- host-sync accounting --------------------------------------------

    def _count_sync(self, site: str, *tensors: torch.Tensor,
                    event=None) -> None:
        """Count a blocking host read: the caller is about to read
        ``tensors`` (or what ``event`` follows) and the card has not
        finished the work queued before it (an event recorded now has not
        completed).  Reads of ready data, and all reads on the CPU, are
        free and not counted."""
        if event is None:
            if not any(t.is_cuda for t in tensors):
                return
            event = torch.cuda.Event()
            event.record()
        if not event.query():
            self._metrics.counter("host_syncs_total", {"site": site}).inc()

    # -- admission -----------------------------------------------------

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self._metrics.counter("serve_requests_submitted").inc()
        self.queue.put(req)

    def _group_key(self, req: Request) -> tuple:
        """Sort key grouping requests that will share a prefill wave and a
        cached prefix: prompt length, then the matched store key, or before
        anything is published the prompt's first hash block."""
        if self.prefix_store is not None:
            pk = self.prefix_store.peek(req.prompt)
            if pk is not None:
                return (len(req.prompt), pk[0])
        block = (self.prefix_store.block if self.prefix_store is not None
                 else self.prefix.block if self.prefix is not None else 4)
        h = prefix_hashes(req.prompt[:block])[-1] if req.prompt else 0
        return (len(req.prompt), h)

    def _admission_order(self, n: int) -> list[Request]:
        """The next ``n`` requests to admit: FIFO unless ``reorder``; with
        reorder, requests past the fairness age bound first (FIFO among
        themselves), the rest stable-sorted by prefix group."""
        for r in self.pending:
            r.wait_rounds += 1
        if not self.reorder:
            take, self.pending = self.pending[:n], self.pending[n:]
            return take
        overdue = [r for r in self.pending
                   if r.wait_rounds > self.reorder_age_bound]
        rest = [r for r in self.pending
                if r.wait_rounds <= self.reorder_age_bound]
        rest.sort(key=self._group_key)  # stable: FIFO within a group
        ordered = overdue + rest
        take = ordered[:n]
        self.pending = ordered[n:]
        return take

    def _admit(self) -> None:
        while not self.queue.empty():
            self.pending.append(self.queue.get())
        free = [s for s in range(self.slots) if self.active[s] is None]
        if not free or not self.pending:
            return
        wave = [(free.pop(0), req)
                for req in self._admission_order(len(free))]
        if not wave:
            return
        with obs_tracing.span("admit", wave=len(wave)):
            # coalesce: one batched prefill per prompt length in the wave
            by_len: dict[int, list[tuple[int, Request]]] = {}
            for slot, req in wave:
                by_len.setdefault(len(req.prompt), []).append((slot, req))
            for plen, group in by_len.items():
                if self.pipeline == "async":
                    self._prefill_group_async(plen, group)
                else:
                    self._prefill_group_sync(plen, group)

    def _tokens(self, group: list[tuple[int, Request]]) -> torch.Tensor:
        return to_device(torch.tensor([req.prompt for _, req in group],
                                      dtype=torch.int32), self.device)

    def _prefill_counts(self, n: int) -> None:
        self.prefill_calls += 1
        self.prefill_requests += n
        self._metrics.counter("serve_prefill_calls").inc()
        self._metrics.counter("serve_prefill_requests").inc(n)

    def _account_prefill(self, plen: int, rows: int, steps: float,
                         hit: bool, faulted: bool) -> None:
        """Prefix-path iteration accounting for one wave: an all-miss wave
        is the cold path bit for bit, so its steps are the cold reference
        of its ``(plen, rows)``; a hit wave is credited against it."""
        self.prefill_iters += steps
        ck = (plen, rows)
        if faulted:
            return  # a faulted wave's step count is not a fair reference
        if hit:
            ref = self._cold_prefill_ref.get(ck)
            if ref is not None:
                saved = max(0.0, ref - steps)
                self.saved_iters += saved
                obs_metrics.record_prefix_saved_iters([saved])
        else:
            self._cold_prefill_ref.setdefault(ck, steps)

    # -- sync pipeline -----------------------------------------------------

    def _prefix_lookup(self, plen: int,
                       group: list[tuple[int, Request]]) -> tuple[list, list]:
        """Consult the prefix index for every request of a group: the
        leases (released after the wave publishes) and the snapshots for
        :func:`lm.prefix_seed_carry` (``None`` = a cold row)."""
        matches, snapshots = [], []
        for _slot, req in group:
            m = self.prefix.lookup(req.prompt)
            matches.append(m)
            if m is None:
                snapshots.append(None)
                obs_metrics.record_prefix_lookup("miss", prompt_tokens=plen)
            else:
                e = m.entry
                snapshots.append((e.z, e.u, e.v, e.count))
                obs_metrics.record_prefix_lookup(
                    "hit" if m.exact else "partial",
                    matched_tokens=m.length, prompt_tokens=plen)
        return matches, snapshots

    def _prefix_publish(self, group: list[tuple[int, Request]], pf_carry,
                        matches: list,
                        skip_rows: set[int] = frozenset()) -> None:
        """Publish the wave's converged prefill carries (host copies) and
        return the leases; ``skip_rows`` faulted and are not published."""
        lr = pf_carry.lowrank
        self._count_sync("prefix_publish", pf_carry.z, lr.u, lr.v, lr.count)
        z_h, u_h, v_h = pf_carry.z.cpu(), lr.u.cpu(), lr.v.cpu()
        c_h = lr.count.tolist()
        for row, (_slot, req) in enumerate(group):
            if row not in skip_rows:
                self.prefix.publish(req.prompt, z_h[row], u_h[:, row],
                                    v_h[:, row], c_h[row])
        for m in matches:
            if m is not None:
                self.prefix.release(m)

    def _prefill_group_sync(self, plen: int,
                            group: list[tuple[int, Request]],
                            allow_prefix: bool = True) -> None:
        # ``allow_prefix=False`` is the containment cold retry: the same
        # request prefilled again with no prefix seed
        use_prefix = self.prefix is not None and allow_prefix
        toks = self._tokens(group)
        matches = None
        with obs_tracing.span("prefill", plen=plen, wave=len(group)):
            if use_prefix:
                matches, snapshots = self._prefix_lookup(plen, group)
                pc, pl = lm.prefix_seed_carry(self.cfg, len(group), plen,
                                              snapshots, self.device)
                (logits, cache_new, _lens, seeded, pf_carry, steps,
                 status) = lm.prefill(
                    self.params, {"tokens": toks}, self.cfg, self.max_len,
                    carry=lm.deq_solve_carry(self.cfg, len(group), 1,
                                             self.device),
                    prefix_carry=pc, prefix_len=pl, return_status=True)
            else:
                logits, cache_new, seeded, steps, status = self._prefill(
                    toks, len(group))
            last = logits[:, -1].float()
            self._count_sync("prefill_block", last, status)
            # the prefill's one host read (it lands the metrics bridge too)
            nxt_all, st = obs_metrics.read(last.argmax(-1), status)
        self.solve_log.append({"phase": "prefill", "rows": len(group),
                               "steps": steps, "status": st})
        failed = ({row: st[row] for row in range(len(group))
                   if st[row] >= STATUS_DIVERGED} if self._guarded else {})
        if use_prefix:
            # the solver counted its steps on the host: the reference's
            # ``steps_fetch`` read has nothing to wait for here
            self._account_prefill(plen, len(group), steps,
                                  any(m is not None for m in matches),
                                  bool(failed))
            self._prefix_publish(group, pf_carry, matches,
                                 skip_rows=set(failed))
        self._prefill_counts(len(group))
        # one batched scatter per wave overwrites every field of the leased
        # rows, so the lease skips its own cold reset
        if self.carries is not None:
            for slot, req in group:
                self.carries.lease(slot, req.uid, reset=False)
            self.carries.update(write_carry_rows(
                self.carries.carry, seeded, [slot for slot, _ in group],
                list(range(len(group)))))
        retry: list[tuple[int, Request]] = []
        for row, (slot, req) in enumerate(group):
            if row in failed:
                name = STATUS_NAMES.get(failed[row], str(failed[row]))
                self._metrics.counter("serve_request_faults_total",
                                      {"status": name}).inc()
                if use_prefix and matches[row] is not None:
                    # the seed that poisoned this solve must not seed
                    # the next request
                    self.prefix.evict_poisoned(req.prompt)
                if not req.retried:
                    retry.append((slot, req))
                else:
                    req.error = name
                    req.done = True
                    self._metrics.counter("serve_requests_completed").inc()
                    self._release(slot)
                continue
            self._write_slot(cache_new, slot, row)
            nxt = int(nxt_all[row])
            req.out.append(nxt)
            self._metrics.histogram("serve_ttft_ms").observe(
                (time.perf_counter() - req.t_submit) * 1e3)
            if self._record:
                self.recorded_logits.setdefault(req.uid, []).append(
                    last[row].cpu().numpy())
                if use_prefix:
                    self.recorded_steps.setdefault(req.uid, []).append(steps)
            self.active[slot] = req
            # fills, not item assignments (which copy the value over from
            # pageable host memory and wait)
            self.lengths[slot:slot + 1].fill_(plen)
            self.cur_tok[slot:slot + 1].fill_(nxt)
        for slot, req in retry:
            # one cold retry: same request, fresh solve, no prefix seed
            req.retried = True
            self._metrics.counter("serve_request_retries_total").inc()
            self._prefill_group_sync(plen, [(slot, req)], allow_prefix=False)

    def _step_sync(self) -> int:
        self._admit()
        mask = [r is not None and not r.done for r in self.active]
        if not any(mask):
            return 0
        mask_t = to_device(torch.tensor(mask, dtype=torch.bool), self.device)
        t0 = time.perf_counter()
        with obs_tracing.span("decode", active=sum(mask)):
            logits, new_carry, steps, status = self._decode(mask_t)
            if self.carries is not None:
                if self.carries.max_age is not None:
                    self._count_sync("carry_stale", new_carry.age)
                self.carries.update(new_carry)
            nxt = logits.float().argmax(-1).int()
            self._count_sync("decode_fetch", nxt, status)
            # the tick's one host read (it lands the metrics bridge too)
            nxt_l, st = obs_metrics.read(nxt, status)
        self.solve_log.append({"phase": "decode", "rows": sum(mask),
                               "steps": steps,
                               "status": [c for c, a in zip(st, mask) if a]})
        tok_ms = (time.perf_counter() - t0) * 1e3
        self.lengths = self.lengths + mask_t.int()
        self.cur_tok = torch.where(mask_t, nxt, self.cur_tok)
        logits_np = logits.float().cpu().numpy() if self._record else None
        for s, req in enumerate(self.active):
            if req is None or req.done:
                continue
            if self._guarded and st[s] >= STATUS_DIVERGED and req.error is None:
                # mid-decode fault: contained in the solve (restart from
                # z0); recorded stickily, the request keeps generating
                req.error = STATUS_NAMES.get(st[s], str(st[s]))
                self._metrics.counter("serve_request_faults_total",
                                      {"status": req.error}).inc()
            tok = int(nxt_l[s])
            req.out.append(tok)
            self._metrics.histogram("serve_token_ms").observe(tok_ms)
            self._metrics.counter("serve_tokens_total").inc()
            if self._record:
                self.recorded_logits.setdefault(req.uid, []).append(
                    logits_np[s])
                self.recorded_steps.setdefault(req.uid, []).append(steps)
            if tok == self.eos or len(req.out) >= req.max_new_tokens:
                req.done = True
                self.active[s] = None
                self._metrics.counter("serve_requests_completed").inc()
                self._release(s)
        return sum(mask)

    # -- async pipeline ---------------------------------------------------

    def _prefill_group_async(self, plen: int,
                             group: list[tuple[int, Request]],
                             allow_prefix: bool = True) -> None:
        """Dispatch one wave: gather the prefix seeds from the device
        store, solve, scatter the converged carry back, pick the next
        tokens and integrate the wave into the live slot state (KV caches,
        carry rows, lengths, current tokens, active mask, token counts),
        all on the device.  ``allow_prefix=False`` is the containment cold
        retry: no store gather or scatter."""
        use_store = self.prefix_store is not None and allow_prefix
        n = len(group)
        dev = self.device
        toks = self._tokens(group)
        # a landing whose slot's request has since been retried (epoch
        # bumped) is stale and is dropped
        meta: dict[str, Any] = {
            "plen": plen, "epochs": {slot: req.epoch for slot, req in group}}
        with obs_tracing.span("prefill_dispatch", plen=plen, wave=n):
            ints = [[s for s, _ in group],
                    [req.max_new_tokens for _, req in group]]
            if use_store:
                # host bookkeeping over ints: longest-prefix-match rows,
                # then publish planning; the payload stays on the device
                slot_in, plen_vec = [], []
                for _slot, req in group:
                    m = self.prefix_store.lookup(req.prompt)
                    if m is None:
                        slot_in.append(self.prefix_store.scratch)
                        plen_vec.append(0)
                        obs_metrics.record_prefix_lookup(
                            "miss", prompt_tokens=plen)
                    else:
                        slot_in.append(m.slot)
                        plen_vec.append(m.length)
                        obs_metrics.record_prefix_lookup(
                            "hit" if m.exact else "partial",
                            matched_tokens=m.length, prompt_tokens=plen)
                ints += [slot_in, plen_vec,
                         [self.prefix_store.plan_publish(req.prompt)
                          for _slot, req in group]]
                meta["hit"] = any(p > 0 for p in plen_vec)
            # one host-to-card copy for every index vector of the wave
            ints_t = to_device(torch.tensor(ints, dtype=torch.int32), dev)
            slots_t = ints_t[0].long()
            if use_store:
                pc, pl = lm.prefix_gather_carry(
                    self.cfg, n, plen, self.prefix_store.arrays, ints_t[2],
                    ints_t[3])
                (logits, cache_new, _lens, seeded, pf_carry, steps,
                 status) = lm.prefill(
                    self.params, {"tokens": toks}, self.cfg, self.max_len,
                    carry=lm.deq_solve_carry(self.cfg, n, 1, dev),
                    prefix_carry=pc, prefix_len=pl, return_status=True)
                prefix_store_scatter(self.prefix_store.arrays, pf_carry,
                                     ints_t[4])
                meta["steps"] = steps
            else:
                logits, cache_new, seeded, steps, status = self._prefill(
                    toks, n)
            last = logits[:, -1].float()
            nxt = last.argmax(-1).int()
            for live, new, ax in zip(cache_leaves(self.caches),
                                     cache_leaves(cache_new),
                                     self._cache_axes):
                if ax >= 0:
                    live.index_copy_(ax, slots_t, new)
            self.lengths.index_fill_(0, slots_t, plen)
            self.cur_tok.index_copy_(0, slots_t, nxt)
            self._dev_active.index_fill_(0, slots_t, True)
            self._ntok.index_fill_(0, slots_t, 1)
            self._max_new.index_copy_(0, slots_t, ints_t[1])
            for slot, req in group:
                self.active[slot] = req
                self._planned[slot] = 1
            if self.carries is not None:
                for slot, req in group:
                    self.carries.lease(slot, req.uid, reset=False)
                self.carries.carry = write_carry_rows(
                    self.carries.carry, seeded, slots_t,
                    torch.arange(n, device=dev))
        self._prefill_counts(n)
        outs = {"nxt": nxt, "status": status}
        if self._record:
            outs["logits"] = last
        meta["log"] = {"phase": "prefill", "rows": n, "steps": steps,
                       "status": None}
        self.solve_log.append(meta["log"])
        self._push("prefill", group, outs, meta)

    def _tickable(self) -> bool:
        """Some slot still has host-predicted tokens to generate (EOS may
        end a slot earlier on the device; the host learns it at that tick's
        landing, so at most ``async_depth`` frozen ticks follow)."""
        return any(r is not None and not r.done
                   and self._planned[s] < r.max_new_tokens
                   for s, r in enumerate(self.active))

    def _dispatch_tick(self) -> None:
        """One decode tick: solve, pick tokens, and advance the whole slot
        lifecycle on the device (lengths, emitted counts, the EOS / max-new
        done mask, the carry staleness reset)."""
        group = [(s, r) for s, r in enumerate(self.active)
                 if r is not None and not r.done]
        for s, r in group:
            if self._planned[s] < r.max_new_tokens:
                self._planned[s] += 1
        with obs_tracing.span("decode_dispatch", active=len(group)):
            active = self._dev_active
            logits, carry, steps, status = self._decode(active)
            nxt = torch.where(active, logits.float().argmax(-1).int(),
                              self.cur_tok)
            act_i = active.int()
            ntok = self._ntok + act_i
            done_now = active & ((nxt == self.eos) | (ntok >= self._max_new))
            self.cur_tok, self._ntok = nxt, ntok
            self.lengths = self.lengths + act_i
            self._dev_active = active & ~done_now
            outs = {"nxt": nxt, "emitted": active, "done": done_now,
                    "status": status}
            if self.carries is not None:
                if self.carries.max_age is not None:
                    stale = carry.age > self.carries.max_age
                    outs["n_stale"] = stale.sum()
                    carry = reset_carry_rows(carry, stale)
                self.carries.carry = carry
        if self._record:
            outs["logits"] = logits.float()
        log = {"phase": "decode", "rows": None, "steps": steps,
               "status": None}
        self.solve_log.append(log)
        self._push("tick", group, outs,
                   {"epochs": {s: r.epoch for s, r in group}, "log": log,
                    "steps": steps})

    def _calibrate(self) -> None:
        """Pin the card's clock to the wall clock: one wait, for a timing
        event recorded now."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        self._clock0 = (ev, time.perf_counter())

    def _push(self, kind: str, group, outs: dict, meta: dict) -> None:
        """Queue an entry: its outputs, and what the metrics bridge holds,
        copied into host buffers (pinned, without a wait, on the card) and
        an event recorded after them."""
        cuda = self.device.type == "cuda"

        def host(t: torch.Tensor) -> torch.Tensor:
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=cuda).copy_(t, non_blocking=cuda)

        outs_h = {k: host(v) for k, v in outs.items()}
        metrics = [(land, [host(t) for t in ts])
                   for land, ts in self._metrics.take_pending()]
        event = None
        if cuda:
            if self._clock0 is None:
                self._calibrate()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self._inflight.append(_Inflight(kind, list(group), outs_h, event,
                                        time.perf_counter(), meta, metrics))
        self._metrics.gauge("serve_pipeline_inflight").set(
            len(self._inflight))

    def _stamp(self, e: _Inflight) -> float:
        """Wall time at which ``e``'s outputs were ready."""
        if e.event is None:
            return e.t_dispatch
        ev0, wall0 = self._clock0
        return wall0 + ev0.elapsed_time(e.event) / 1e3

    @staticmethod
    def _entry_ready(e: _Inflight) -> bool:
        return e.event is None or e.event.query()

    def _drain_ready(self, force: bool = False) -> int:
        """Land every queued entry that is ready; with ``force``, poll
        (no blocking read) until at least the oldest one lands."""
        landed = 0
        while self._inflight:
            e = self._inflight[0]
            if not self._entry_ready(e):
                if not force:
                    break
                with obs_tracing.span("pipeline_wait", kind=e.kind):
                    # the card keeps working through its queue meanwhile
                    while not self._entry_ready(e):
                        time.sleep(_POLL_S)
            self._inflight.popleft()
            self._land(e)
            landed += 1
            force = False
        self._metrics.gauge("serve_pipeline_inflight").set(
            len(self._inflight))
        return landed

    def _land(self, e: _Inflight) -> None:
        # the entry is ready: reading its host buffers cannot wait
        if e.event is not None:
            self._count_sync(f"{e.kind}_land", event=e.event)
        out = {k: v.numpy() for k, v in e.host.items()}
        for land, host in e.metrics:
            obs_metrics.land_host(land, host)
        t_land = self._stamp(e)
        epochs = e.meta["epochs"]
        status = out["status"]
        log = e.meta["log"]
        if e.kind == "prefill":
            log["status"] = status.tolist()
            self._land_prefill(e, out, t_land, epochs)
            return
        emitted = out["emitted"]
        log["rows"] = int(emitted.sum())
        log["status"] = status[emitted].tolist()
        self._land_tick(e, out, t_land, epochs)

    def _land_prefill(self, e: _Inflight, out: dict, t_land: float,
                      epochs: dict) -> None:
        status, nxt = out["status"], out["nxt"]
        failed: dict[int, int] = {}
        retry: list[tuple[int, Request]] = []
        for row, (slot, req) in enumerate(e.group):
            if epochs.get(slot, req.epoch) != req.epoch:
                continue  # stale landing from before this row's retry
            code = int(status[row])
            if self._guarded and code >= STATUS_DIVERGED:
                # containment: drop this row's token; co-batched healthy
                # rows land normally
                failed[row] = code
                name = STATUS_NAMES.get(code, str(code))
                self._metrics.counter("serve_request_faults_total",
                                      {"status": name}).inc()
                if self.prefix_store is not None:
                    # the wave may have published this row's carry, and a
                    # poisoned seed may have caused the fault: evict the
                    # prompt's whole prefix chain either way
                    self.prefix_store.evict_poisoned(req.prompt)
                if not req.retried:
                    retry.append((slot, req))
                else:
                    req.error = name
                    req.done = True
                    if self.active[slot] is req:
                        self.active[slot] = None
                    self._planned[slot] = 0
                    self._dev_active[slot:slot + 1].fill_(False)
                    self._metrics.counter("serve_requests_completed").inc()
                    self._release(slot)
                continue
            req.out.append(int(nxt[row]))
            self._metrics.histogram("serve_ttft_ms").observe(
                (t_land - req.t_submit) * 1e3)
            if self._record:
                self.recorded_logits.setdefault(req.uid, []).append(
                    out["logits"][row].copy())
        if "steps" in e.meta:
            steps = e.meta["steps"]
            self._account_prefill(e.meta["plen"], len(e.group), steps,
                                  e.meta["hit"], bool(failed))
            if self._record:
                for row, (_slot, req) in enumerate(e.group):
                    if row not in failed:
                        self.recorded_steps.setdefault(req.uid, []).append(
                            steps)
        for slot, req in retry:
            # one cold retry: bump the epoch (in-flight ticks for this slot
            # land stale and are dropped), clear any partial output and
            # dispatch again with no prefix seed; stream order lands the
            # retry after every stale tick, overwriting the slot's state
            req.retried = True
            req.epoch += 1
            req.out.clear()
            self._planned[slot] = 0
            self._metrics.counter("serve_request_retries_total").inc()
            self._prefill_group_async(e.meta["plen"], [(slot, req)],
                                      allow_prefix=False)

    def _land_tick(self, e: _Inflight, out: dict, t_land: float,
                   epochs: dict) -> None:
        nxt, emitted, done = out["nxt"], out["emitted"], out["done"]
        status = out["status"]
        prev = self._last_tick_stamp
        self._last_tick_stamp = t_land
        tok_ms = (t_land - (prev if prev is not None else e.t_dispatch)) * 1e3
        for slot, req in e.group:
            if epochs.get(slot, req.epoch) != req.epoch:
                continue  # stale landing from before this slot's retry
            code = int(status[slot])
            if (emitted[slot] and self._guarded and code >= STATUS_DIVERGED
                    and req.error is None):
                # mid-decode fault: contained in the solve (restart from
                # z0); recorded stickily, the request keeps generating
                req.error = STATUS_NAMES.get(code, str(code))
                self._metrics.counter("serve_request_faults_total",
                                      {"status": req.error}).inc()
            if emitted[slot]:
                req.out.append(int(nxt[slot]))
                self._metrics.histogram("serve_token_ms").observe(tok_ms)
                self._metrics.counter("serve_tokens_total").inc()
                if self._record:
                    self.recorded_logits.setdefault(req.uid, []).append(
                        out["logits"][slot].copy())
                    self.recorded_steps.setdefault(req.uid, []).append(
                        e.meta["steps"])
            if done[slot] and not req.done:
                req.done = True
                if self.active[slot] is req:
                    self.active[slot] = None
                self._metrics.counter("serve_requests_completed").inc()
                self._release(slot)
        n_stale = int(out.get("n_stale", 0))
        if n_stale:
            self.carries._count("stale", n_stale)

    def _step_async(self) -> int:
        self._drain_ready()
        if len(self._inflight) >= self.async_depth:
            self._drain_ready(force=True)
        self._admit()
        while len(self._inflight) >= self.async_depth:
            self._drain_ready(force=True)
        if self._tickable():
            self._dispatch_tick()
            return len(self._inflight)
        if self._inflight:
            self._drain_ready(force=True)
        return len(self._inflight)

    # -- engine tick -----------------------------------------------------

    def step(self) -> int:
        """One engine iteration.  Sync: admit, then one blocking decode
        tick (returns the number of slots decoded).  Async: land what is
        ready, admit, and dispatch the next tick without waiting for the
        previous one (returns the entries in flight)."""
        if self.pipeline == "async":
            return self._step_async()
        with obs_tracing.span("serve_tick"):
            return self._step_sync()

    def drain(self, reqs: list[Request],
              max_ticks: int = 10_000) -> list[Request]:
        with obs_tracing.span("drain", requests=len(reqs)):
            if self.pipeline == "async" and self.device.type == "cuda":
                self._calibrate()
            self._last_tick_stamp = None
            for r in reqs:
                self.submit(r)
            ticks = 0
            while (not self.queue.empty() or self.pending
                   or any(a is not None for a in self.active)
                   or self._inflight) and ticks < max_ticks:
                self.step()
                ticks += 1
            if self._inflight:
                self._drain_ready(force=True)
        return reqs


def _write_row_sharded(live, new, ax: int, slot: int, row: int) -> None:
    """Row ``row`` of the wave's cache leaf ``new`` into slot ``slot`` of
    the live leaf: the wave's rows gathered along ``ax`` (the other dims
    keep the live layout), then written by the ranks whose shard holds the
    slot."""
    from repro_torch.parallel.sharding import redistribute, shard_offset

    pls = tuple(Replicate() if isinstance(p, Shard) and p.dim == ax else p
                for p in live.placements)
    rows = redistribute(new, live.device_mesh, pls).to_local()
    local = live.to_local()
    start = shard_offset(live.shape, live.device_mesh, live.placements)[ax]
    if start <= slot < start + local.shape[ax]:
        local.narrow(ax, slot - start, 1).copy_(rows.narrow(ax, row, 1))


def cache_leaves(caches) -> list[torch.Tensor]:
    """The tensors of a cache tree (``lm.init_cache``: dicts in their
    insertion order, NamedTuples in their field order), in a fixed order."""
    if isinstance(caches, dict):
        return [t for c in caches.values() for t in cache_leaves(c)]
    if isinstance(caches, tuple):
        return [t for c in caches for t in cache_leaves(c)]
    return [caches]


def cache_batch_axes(cfg: ModelConfig) -> list[int]:
    """The batch axis of each of :func:`cache_leaves`, probed once from the
    shapes of a one-row and a two-row cache (-1: a leaf without one), as
    the reference probes it: axis 1 under a stacked layer axis, axis 2 for
    the Mamba leaves under a unit's two stacked axes."""
    one = cache_leaves(lm.init_cache(cfg, 1, 1, "cpu"))
    two = cache_leaves(lm.init_cache(cfg, 2, 1, "cpu"))
    return [next((i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                  if x != y), -1) for a, b in zip(one, two)]


def serve_summary(loop: ServeLoop, reqs: list[Request],
                  seconds: float) -> dict[str, Any]:
    """Host-side digest of a drain: token counts, rate and TTFT."""
    tokens = sum(len(r.out) for r in reqs)
    ttft = loop._metrics.histogram("serve_ttft_ms")
    return {"requests": len(reqs), "tokens": tokens, "seconds": seconds,
            "tok_per_s": tokens / seconds if seconds > 0 else None,
            "ttft_ms_mean": ttft.sum / ttft.count if ttft.count else None,
            "ttft_ms_max": ttft.max if ttft.count else None,
            "prefill_calls": loop.prefill_calls}
