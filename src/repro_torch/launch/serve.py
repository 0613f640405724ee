"""Serving launcher: ``python -m repro_torch.launch.serve [--deq] [...]``.

The port of ``repro/launch/serve.py``: builds the model (random weights from
``--seed``), drains a synthetic request stream through the fixed-slot
``ServeLoop`` and prints the rate and the first requests' outputs.  As in
the reference, ``--pipeline async`` (the default) runs the completion-queue
pipeline with the slot state and the prefix store on the device, and
``--pipeline sync`` the blocking loop; ``--prefix-cache`` seeds each
prefill from the longest cached prompt prefix, ``--reorder`` groups queued
requests by prefix.  The summary gives the prefix cache's hits, entries and
prefill iterations, and the blocking host reads the loop counted
(``host_syncs_total``).  The prompts are drawn exactly as the JAX launcher
draws them (``np.random.default_rng(seed)``), so both launchers serve the
same stream.

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path.
The default model is the full published config (``get_config``);
``--smoke`` selects the reduced ``smoke_config`` for CPU runs.  Without
``--deq`` the model is the layer stack (the reference's default path; the
MoE configs run their fine-grained MoE, DeepSeek-V2-Lite its MLA); with
it, the weight-tied DEQ solved by SHINE.
``--metrics-prom-out`` keeps a Prometheus text file of the metrics registry
(rewritten every 10 s and at the end); ``--trace-out`` writes a Chrome
trace of the drain's spans.

``--mesh DxM`` serves sharded on a (data=D, model=M) mesh, one process per
rank: ``torchrun --nproc-per-node D*M -m repro_torch.launch.serve --mesh
DxM [--prefix-cache]`` (NCCL on the cards; with ``--device cpu``, gloo).
The process world is the counterpart of the JAX launcher's
``--force-devices``.  The slots split over "data" and the KV cache's
length over "model" (``DECODE_RULES``; prefill under ``PREFILL_RULES``),
the DEQ carry stays batch-split between ticks; either pipeline and either
prefix cache runs there, every rank on the same schedule, and only rank 0
prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, make_ctx
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    build_device_mesh,
    init_distributed,
    parse_mesh,
)
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.parallel.sharding import NULL_CTX
from repro_torch.runtime.serving import Request, ServeLoop


def make_prompts(rng: np.random.Generator, vocab_size: int, requests: int,
                 shared_prefix: int = 0) -> list[list[int]]:
    """The JAX launcher's synthetic prompt stream."""
    if shared_prefix:
        base = rng.integers(2, vocab_size, size=shared_prefix).tolist()
        return [base + rng.integers(2, vocab_size, size=4).tolist()
                for _ in range(requests)]
    return [rng.integers(2, vocab_size, size=int(rng.integers(4, 12))).tolist()
            for _ in range(requests)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=sorted(ARCHS))
    ap.add_argument("--deq", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced smoke config (CPU-sized) instead of the "
                         "full published config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--carry-max-age", type=int, default=None,
                    help="DEQ carry staleness bound: evict per-slot solve "
                         "state older than this many solves")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix carry cache: seed each "
                         "prefill solve from the longest cached prompt "
                         "prefix instead of cold-starting")
    ap.add_argument("--prefix-cache-slots", type=int, default=32,
                    help="prefix-cache capacity (entries; device rows for "
                         "the async pipeline); 0 = always-miss cold "
                         "accounting arm")
    ap.add_argument("--prefix-block", type=int, default=4,
                    help="prefix-cache publication granularity: entries are "
                         "stored at multiples of this many tokens (plus the "
                         "full prompt length)")
    ap.add_argument("--prefix-max-age", type=int, default=None,
                    help="prefix-cache staleness bound: evict entries not "
                         "republished within this many cache operations")
    ap.add_argument("--pipeline", default="async", choices=("async", "sync"),
                    help="serving pipeline: 'async' (default) lands waves "
                         "and ticks through a completion queue with the "
                         "slot state and prefix store on the device and no "
                         "blocking host read of its own; 'sync' blocks on "
                         "every wave and tick")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve sharded on a (data=D, model=M) mesh, one "
                         "rank per process under torchrun")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="async pipeline: entries in flight before dispatch "
                         "waits for the oldest to land")
    ap.add_argument("--reorder", action="store_true",
                    help="prefix-aware admission: stable-sort queued "
                         "requests by matched prefix so prompts sharing a "
                         "cached prefix land in one wave")
    ap.add_argument("--reorder-age-bound", type=int, default=8,
                    help="fairness bound for --reorder: a request passed "
                         "over this many admission rounds is admitted FIFO "
                         "ahead of any grouping")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="synthetic prompt stream: all prompts share this "
                         "many leading tokens; 0 = fully random prompts")
    ap.add_argument("--dtype", default=None,
                    choices=("bfloat16", "float32"),
                    help="the model's parameter and activation dtype "
                         "(default the config's; a sharded bf16 run may "
                         "part from the unsharded one at a near tie of two "
                         "logits, an f32 one does not)")
    ap.add_argument("--qn-dtype", default=None,
                    choices=("bfloat16", "float32"),
                    help="storage dtype of the quasi-Newton U/V ring "
                         "(default bf16; coefficients accumulate f32)")
    ap.add_argument("--no-guard", action="store_true",
                    help="run the DEQ solves without the numerical-fault "
                         "guards")
    ap.add_argument("--metrics-out", default="",
                    help="write a metrics-registry JSON snapshot here after "
                         "the drain")
    ap.add_argument("--metrics-prom-out", default="",
                    help="write (and refresh every 10 s) a Prometheus "
                         "text exposition of the metrics registry here")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace JSON of the drain here "
                         "(enables span tracing)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "meta":
        ap.error("--device meta holds shapes only; the dry-run "
                 "(repro_torch.launch.dryrun) runs steps on it")
    if args.metrics_out or args.metrics_prom_out:
        obs_metrics.set_enabled(True)
    if args.trace_out:
        obs_tracing.set_enabled(True)
    flusher = (obs_metrics.PromFlusher(args.metrics_prom_out).start()
               if args.metrics_prom_out else None)
    cfg = (smoke_config(args.arch, deq=args.deq) if args.smoke
           else get_config(args.arch, deq=args.deq))
    if args.qn_dtype or args.no_guard:
        deq = cfg.deq
        if args.qn_dtype:
            deq = dataclasses.replace(deq, qn_dtype=args.qn_dtype)
        if args.no_guard:
            deq = dataclasses.replace(deq, guard=False)
        cfg = dataclasses.replace(cfg, deq=deq)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if cfg.family == "audio":
        raise SystemExit("encoder-only arch: no autoregressive serving")
    ctx = pctx = NULL_CTX
    if args.mesh:
        init_distributed(device.type)
        mesh = build_device_mesh(parse_mesh(args.mesh), device.type)
        ctx = make_ctx(cfg, mesh, SHAPES["decode_32k"])
        pctx = make_ctx(cfg, mesh, SHAPES["prefill_32k"])
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    params = lm.init_params(cfg, seed=args.seed, device=device)
    if ctx.running:
        params = lm.place_params(params, cfg, ctx)
    main_rank = not ctx.running or torch.distributed.get_rank() == 0

    loop = ServeLoop(params, cfg, slots=args.slots, max_len=args.max_len,
                     carry_max_age=args.carry_max_age,
                     prefix_cache=args.prefix_cache,
                     prefix_cache_slots=args.prefix_cache_slots,
                     prefix_block=args.prefix_block,
                     prefix_max_age=args.prefix_max_age,
                     pipeline=args.pipeline, async_depth=args.async_depth,
                     reorder=args.reorder,
                     reorder_age_bound=args.reorder_age_bound,
                     ctx=ctx, prefill_ctx=pctx)
    rng = np.random.default_rng(args.seed)
    prompts = make_prompts(rng, cfg.vocab_size, args.requests,
                           args.shared_prefix)
    reqs = [Request(uid=i, prompt=prompts[i],
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    loop.drain(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if not main_rank:
        torch.distributed.destroy_process_group()
        return
    tokens = sum(len(r.out) for r in reqs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} device={where} served {len(reqs)} requests, "
          f"{tokens} tokens in {dt:.2f}s ({tokens / dt:.1f} tok/s)")
    for r in reqs[:4]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.out}")
    cache = loop.prefix if loop.prefix is not None else loop.prefix_store
    if cache is not None:
        st = cache.stats()
        print(f"prefix cache: {st['hits']}/{st['lookups']} lookups hit, "
              f"{st['entries']} entries ({st['tokens']} tokens) held, "
              f"evictions={st['evictions']}; prefill iters "
              f"{loop.prefill_iters:.0f} total, {loop.saved_iters:.0f} saved")
    syncs = {dict(m["labels"])["site"]: m["value"]
             for m in obs_metrics.default_registry().snapshot()["metrics"]
             if m["name"] == "host_syncs_total"}
    print(f"{args.pipeline} pipeline: {sum(syncs.values()):.0f} blocking "
          f"host syncs recorded {syncs}")
    if args.metrics_out:
        obs_metrics.default_registry().write_json(args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    if flusher is not None:
        flusher.stop()
        print(f"prometheus exposition -> {args.metrics_prom_out}")
    if args.trace_out:
        obs_tracing.write(args.trace_out)
        print(f"chrome trace -> {args.trace_out}")
    if ctx.running:
        print(f"mesh {dict(ctx.mesh.shape)} over "
              f"{torch.distributed.get_backend()}")
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
