"""Example: batched serving with the continuous-batching loop, on the
PyTorch port.

The port's counterpart of ``examples/serve_lm.py``: a small LM (random
weights from seed 0) serves a stream of token requests through the
fixed-slot engine -- prefill into slot caches, one decode step per tick
across all active slots.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--deq] [--device cpu]
(the default device is the CUDA card).
"""

import argparse
import time

import numpy as np

from repro_torch.configs.registry import smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.runtime.serving import Request, ServeLoop


def make_requests(vocab: int, n: int, seed: int = 0) -> list[Request]:
    """``n`` prompts of 4-15 tokens, 12 new tokens each, drawn as the JAX
    example draws them."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(2, vocab,
                                        size=int(rng.integers(4, 16))).tolist(),
                    max_new_tokens=12)
            for i in range(n)]


def serve(params, cfg, reqs: list[Request], slots: int) -> float:
    """Drain ``reqs`` greedily through a ``slots``-slot loop with 96-token
    caches and no EOS; returns the seconds it took."""
    loop = ServeLoop(params, cfg, slots=slots, max_len=96, eos_id=-1)
    t0 = time.perf_counter()
    loop.drain(reqs)
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--deq", action="store_true",
                    help="serve the DEQ/SHINE form of the model")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch, deq=args.deq)
    params = lm.init_params(cfg, seed=0, device=resolve_device(args.device))
    reqs = make_requests(cfg.vocab_size, args.requests)
    dt = serve(params, cfg, reqs, args.slots)
    tok = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests / {tok} tokens in {dt:.1f}s "
          f"({tok/dt:.1f} tok/s, {args.slots} slots, greedy)")
    for r in reqs[:3]:
        print(f"  req {r.uid}: {len(r.prompt)} prompt -> {r.out}")
    return reqs


if __name__ == "__main__":
    main()
