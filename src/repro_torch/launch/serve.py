"""Serving launcher: ``python -m repro_torch.launch.serve --deq [...]``.

The port of ``repro/launch/serve.py``: builds the model (random weights from
``--seed``), drains a synthetic request stream through the fixed-slot
``ServeLoop`` and prints the rate and the first requests' outputs.  It
runs the sync pipeline only, so it has no ``--pipeline`` flag until the
async pipeline is ported.  The prompts are drawn exactly as the JAX launcher draws them
(``np.random.default_rng(seed)``), so both launchers serve the same stream.

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path.
The default model is the full published config (``get_config``);
``--smoke`` selects the reduced ``smoke_config`` for CPU runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
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
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="synthetic prompt stream: all prompts share this "
                         "many leading tokens; 0 = fully random prompts")
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
    args = ap.parse_args(argv)

    if not args.deq:
        raise SystemExit("repro_torch serves the DEQ model so far: pass --deq")
    device = resolve_device(args.device)
    cfg = (smoke_config(args.arch, deq=True) if args.smoke
           else get_config(args.arch, deq=True))
    if args.qn_dtype or args.no_guard:
        deq = cfg.deq
        if args.qn_dtype:
            deq = dataclasses.replace(deq, qn_dtype=args.qn_dtype)
        if args.no_guard:
            deq = dataclasses.replace(deq, guard=False)
        cfg = dataclasses.replace(cfg, deq=deq)
    params = lm.init_params(cfg, seed=args.seed, device=device)

    loop = ServeLoop(params, cfg, slots=args.slots, max_len=args.max_len,
                     carry_max_age=args.carry_max_age)
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
    tokens = sum(len(r.out) for r in reqs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} device={where} served {len(reqs)} requests, "
          f"{tokens} tokens in {dt:.2f}s ({tokens / dt:.1f} tok/s)")
    for r in reqs[:4]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.out}")
    if args.metrics_out:
        d = os.path.dirname(args.metrics_out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.metrics_out, "w") as fh:
            json.dump(obs_metrics.snapshot(), fh, indent=1, sort_keys=True)
        print(f"metrics snapshot -> {args.metrics_out}")


if __name__ == "__main__":
    main()
