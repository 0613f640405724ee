"""End-to-end run on the PyTorch port: train a ~100M-parameter DEQ
language model on the synthetic token pipeline, with the full stack --
Trainer (checkpoint/restart, preemption guard), WSD/cosine schedule, AdamW,
and the paper's SHINE backward on the weight-tied fixed-point backbone.

The port's counterpart of ``examples/train_deq_lm.py``, with its sizes
(~100M parameters, 300 steps).  Use --arch/--backward to try other
architectures / backward modes.

Run:  PYTHONPATH=src python examples/torch_train_deq_lm.py [--steps 300]
      [--device cpu]   (the default device is the CUDA card)
"""

import argparse
import dataclasses

from repro_torch.configs.base import DEQSettings, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_lm_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.runtime.trainer import Trainer


def hundred_m_config(arch: str, backward: str, deq: bool):
    """~100M-param reduced config of the chosen architecture family."""
    cfg = get_config(arch)
    kw = dict(
        num_layers=4, d_model=1024, num_heads=16, num_kv_heads=16, d_ff=2816,
        vocab_size=32064, head_dim=64, max_seq=512,
    )
    if cfg.family == "moe":
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, num_shared=1, top_k=2, expert_d_ff=256,
            first_k_dense=1, dense_d_ff=1536)
    if deq:
        # 2 weight-tied blocks solved ~10 Broyden steps = effective depth 20
        kw["deq"] = DEQSettings(
            enabled=True, num_blocks=2, solver="broyden", max_steps=10,
            tol=1e-3, memory=10, backward=backward, refine_steps=5)
    return dataclasses.replace(cfg, **kw)


def train_config(cfg, steps: int, batch: int, seq: int,
                 checkpoint_dir: str | None) -> TrainConfig:
    return TrainConfig(
        steps=steps, global_batch=batch, seq_len=seq,
        lr=3e-4, warmup_steps=20, schedule=cfg.schedule, zero1=False,
        checkpoint_dir=checkpoint_dir, checkpoint_every=100,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--backward", default="shine_fallback")
    ap.add_argument("--no-deq", action="store_true",
                    help="train the explicit (non-DEQ) form for comparison")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--checkpoint-dir", default="/tmp/shine_deq_lm_torch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = hundred_m_config(args.arch, args.backward, deq=not args.no_deq)
    tcfg = train_config(cfg, args.steps, args.batch, args.seq,
                        args.checkpoint_dir)
    n = lm.param_count(cfg)
    print(f"family={cfg.family} deq={cfg.deq.enabled} "
          f"backward={cfg.deq.backward if cfg.deq.enabled else 'n/a'} "
          f"params={n/1e6:.1f}M device={device}")

    trainer = Trainer(cfg, tcfg, device=device)
    batches = make_lm_batch_iterator(cfg, args.batch, args.seq, seed=0,
                                     device=device)
    state = trainer.run(batches, steps=args.steps, log_every=20)
    print(f"done at step {int(state.step)}; checkpoints in "
          f"{args.checkpoint_dir}")
    return state


if __name__ == "__main__":
    main()
