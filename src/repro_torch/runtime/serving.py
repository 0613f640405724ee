"""Batched serving loop: fixed-slot continuous batching over prefill/decode.

The port of the sync pipeline of ``repro/runtime/serving.py``.  A
``ServeLoop`` owns B slots.  Each tick admits queued requests into free
slots and runs ONE ``decode_step`` for all slots, inactive ones masked:

  * **Request coalescing** -- admission groups the wave's prompts by length
    and prefills each group in one batched call.
  * **Per-sample convergence masking** -- the active-slot mask is passed to
    ``decode_step``; the DEQ solve freezes inactive slots and exits as soon
    as every live slot converges.
  * **Persistent solve state** -- each slot owns a
    :class:`~repro_torch.implicit.CarryCache` row: the equilibrium and qN
    ring at token *t* warm-start token *t+1*, the prefill's last-token
    equilibrium seeds token 0, and a recycled slot is evicted cold.
  * **Fault containment** (guarded DEQ models) -- a prefill row whose solve
    faults (DIVERGED / NONFINITE / STALLED) emits no token and is retried
    once cold; a second fault ends the request with ``error`` set.  A
    faulted decode row keeps generating (the solver already restarted it)
    with the fault recorded on the request.

Every tick blocks on its logits: the host picks tokens with ``argmax``.
The async pipeline and the cross-request prefix caches come with a later
slice.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.solvers import STATUS_DIVERGED, STATUS_NAMES
from repro_torch.implicit.engine import CarryCache, write_carry_rows
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # wall time the request entered the queue; TTFT = first token - submit
    t_submit: float = 0.0
    # solve-health name when this request's own solve faulted; a faulted
    # prefill is retried once cold (``retried`` marks the retry spent)
    error: str | None = None
    retried: bool = False


class ServeLoop:
    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, eos_id: int = 1,
                 carry_max_age: int | None = None, pipeline: str = "sync",
                 record: bool = False):
        if pipeline != "sync":
            raise ValueError(
                f"pipeline {pipeline!r} is not ported yet; use 'sync'")
        self.params, self.cfg = params, cfg
        self.device = lm.params_device(params)
        self.slots, self.max_len, self.eos = slots, max_len, eos_id
        self.pipeline = pipeline
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.pending: list[Request] = []
        self.active: list[Request | None] = [None] * slots
        self.caches = lm.init_cache(cfg, slots, max_len, self.device)
        self.lengths = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)
        self.cur_tok = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)
        self.prefill_calls = 0
        self.prefill_requests = 0
        self._metrics = obs_metrics.default_registry()
        # record mode (tests): per-request last-position logits and
        # per-decode-solve step counts, as the JAX ServeLoop records them
        self._record = record
        self.recorded_logits: dict[int, list[np.ndarray]] = {}
        self.recorded_steps: dict[int, list[float]] = {}
        # every solve the loop ran: phase, live rows, steps, row statuses
        self.solve_log: list[dict[str, Any]] = []
        self.carries = CarryCache(
            lambda: lm.deq_solve_carry(cfg, slots, 1, self.device), slots,
            max_age=carry_max_age)
        self._guarded = bool(cfg.deq.guard)

    # -- admission -----------------------------------------------------

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self._metrics.counter("serve_requests_submitted").inc()
        self.queue.put(req)

    def _admit(self) -> None:
        while not self.queue.empty():
            self.pending.append(self.queue.get())
        free = [s for s in range(self.slots) if self.active[s] is None]
        if not free or not self.pending:
            return
        n = min(len(free), len(self.pending))
        take, self.pending = self.pending[:n], self.pending[n:]
        wave = [(free.pop(0), req) for req in take]
        # coalesce: one batched prefill per prompt length in the wave
        by_len: dict[int, list[tuple[int, Request]]] = {}
        for slot, req in wave:
            by_len.setdefault(len(req.prompt), []).append((slot, req))
        for plen, group in by_len.items():
            self._prefill_group(plen, group)

    def _prefill_group(self, plen: int,
                       group: list[tuple[int, Request]]) -> None:
        toks = torch.tensor([req.prompt for _, req in group],
                            dtype=torch.int32, device=self.device)
        wave_carry = lm.deq_solve_carry(self.cfg, len(group), 1, self.device)
        logits, cache_new, _lens, seeded, steps, status = lm.prefill(
            self.params, {"tokens": toks}, self.cfg, self.max_len,
            carry=wave_carry, return_steps=True, return_status=True)
        last = logits[:, -1].float()
        nxt_all = last.argmax(-1).tolist()
        st = status.tolist()
        self.solve_log.append({"phase": "prefill", "rows": len(group),
                               "steps": steps, "status": st})
        failed = ({row: st[row] for row in range(len(group))
                   if st[row] >= STATUS_DIVERGED} if self._guarded else {})
        self.prefill_calls += 1
        self.prefill_requests += len(group)
        self._metrics.counter("serve_prefill_calls").inc()
        self._metrics.counter("serve_prefill_requests").inc(len(group))
        # one batched scatter per wave overwrites every field of the leased
        # rows, so the lease skips its own cold reset
        for slot, _req in group:
            self.carries.lease(slot, _req.uid, reset=False)
        self.carries.update(write_carry_rows(
            self.carries.carry, seeded, [slot for slot, _ in group],
            list(range(len(group)))))
        retry: list[tuple[int, Request]] = []
        kc, vc = self.caches["deq"]
        nk, nv = cache_new["deq"]
        for row, (slot, req) in enumerate(group):
            if row in failed:
                name = STATUS_NAMES.get(failed[row], str(failed[row]))
                self._metrics.counter("serve_request_faults_total",
                                      {"status": name}).inc()
                if not req.retried:
                    retry.append((slot, req))
                else:
                    req.error = name
                    req.done = True
                    self._metrics.counter("serve_requests_completed").inc()
                    self.carries.release(slot)
                continue
            kc[:, slot] = nk[:, row]
            vc[:, slot] = nv[:, row]
            nxt = int(nxt_all[row])
            req.out.append(nxt)
            self._metrics.histogram("serve_ttft_ms").observe(
                (time.perf_counter() - req.t_submit) * 1e3)
            if self._record:
                self.recorded_logits.setdefault(req.uid, []).append(
                    last[row].cpu().numpy())
            self.active[slot] = req
            self.lengths[slot] = plen
            self.cur_tok[slot] = nxt
        for slot, req in retry:
            # one cold retry: same request, fresh solve
            req.retried = True
            self._metrics.counter("serve_request_retries_total").inc()
            self._prefill_group(plen, [(slot, req)])

    # -- engine tick -----------------------------------------------------

    def step(self) -> int:
        """Admit, then one blocking decode tick; returns the number of
        active slots decoded."""
        self._admit()
        mask = [r is not None and not r.done for r in self.active]
        if not any(mask):
            return 0
        mask_t = torch.tensor(mask, dtype=torch.bool, device=self.device)
        t0 = time.perf_counter()
        logits, self.caches, new_carry, steps, status = lm.decode_step(
            self.params, self.caches, self.cur_tok, self.lengths, self.cfg,
            active=mask_t, carry=self.carries.carry, return_steps=True,
            return_status=True)
        self.carries.update(new_carry)
        nxt = logits.float().argmax(-1).int()
        nxt_l = nxt.tolist()
        st = status.tolist()
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
                self.carries.release(s)
        return sum(mask)

    def drain(self, reqs: list[Request],
              max_ticks: int = 10_000) -> list[Request]:
        for r in reqs:
            self.submit(r)
        ticks = 0
        while (not self.queue.empty() or self.pending
               or any(a is not None for a in self.active)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return reqs


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
