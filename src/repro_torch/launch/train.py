"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--deq]``.

The port of ``repro/launch/train.py``: runs the :class:`Trainer` (restore
or init, checkpoints, rollback, preemption) on synthetic token batches,
for the layer stack (rematerialised as the config's ``remat`` says) or,
with ``--deq``, its DEQ/SHINE form.
The JAX launcher's flags plus ``--device``.  ``--mesh single|multi``
trains on the production mesh, (data=16, model=16) or (pod=2, data=16,
model=16), one process per card under ``torchrun`` (256 or 512 ranks;
fewer raise, as the reference raises with too few devices), and ``--mesh
DxM`` on a (data=D, model=M) mesh of D*M ranks (``torchrun
--nproc-per-node D*M``; gloo with ``--device cpu``), with ZeRO-1 moments
and any ``--grad-accum``; ``--mesh none`` (the default) is one process.
Unknown ``--backward``/``--solver`` values are rejected with the
registered names.  ``--metrics-prom-out`` keeps a Prometheus text
file of the metrics registry (rewritten every 10 s and at the end);
``--trace-out`` writes a Chrome trace of the run's spans and phases.

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path.
The default model is the full published config; ``--smoke`` selects the
reduced ``smoke_config``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, make_ctx
from repro_torch.data.pipeline import make_lm_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.implicit import ESTIMATORS, SOLVERS
from repro_torch.launch.mesh import (
    build_device_mesh,
    init_distributed,
    make_production_mesh,
    parse_mesh,
)
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.parallel.sharding import NULL_CTX
from repro_torch.runtime.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--deq", action="store_true",
                    help="DEQ/SHINE form: weight-tied fixed-point backbone")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backward", default=None, choices=ESTIMATORS.names(),
                    help="DEQ backward cotangent estimator")
    ap.add_argument("--solver", default=None, choices=SOLVERS.names(),
                    help="DEQ forward fixed-point solver")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    help="none: one process; single/multi: the production "
                         "mesh, DxM: a (data=D, model=M) mesh; one rank per "
                         "process under torchrun")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="",
                    help="write a metrics-registry JSON snapshot here after "
                         "the run")
    ap.add_argument("--metrics-prom-out", default="",
                    help="write (and refresh every 10 s) a Prometheus "
                         "text exposition of the metrics registry here")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace JSON of the run here "
                         "(enables span tracing)")
    ap.add_argument("--checkpoint-lean", action="store_true",
                    help="omit the u/v quasi-Newton carry ring from "
                         "checkpoints (restore zero-fills it)")
    ap.add_argument("--qn-dtype", default=None,
                    choices=("bfloat16", "float32"),
                    help="storage dtype of the quasi-Newton U/V ring "
                         "(default bf16; coefficients accumulate f32)")
    ap.add_argument("--no-guard", action="store_true",
                    help="run the DEQ solves without the numerical-fault "
                         "guards")
    ap.add_argument("--skip-budget", type=int, default=None,
                    help="consecutive non-finite-update skips tolerated "
                         "before rolling back to the last checkpoint")
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
    cfg = smoke_config(args.arch, deq=args.deq) if args.smoke \
        else get_config(args.arch, deq=args.deq)
    if args.backward or args.solver or args.qn_dtype or args.no_guard:
        deq = cfg.deq
        if args.backward:
            deq = dataclasses.replace(deq, backward=args.backward)
        if args.solver:
            deq = dataclasses.replace(deq, solver=args.solver)
        if args.qn_dtype:
            deq = dataclasses.replace(deq, qn_dtype=args.qn_dtype)
        if args.no_guard:
            deq = dataclasses.replace(deq, guard=False)
        cfg = dataclasses.replace(cfg, deq=deq)

    ctx = NULL_CTX
    if args.mesh != "none":
        if args.mesh in ("single", "multi"):
            spec = make_production_mesh(multi_pod=args.mesh == "multi")
        else:
            try:
                spec = parse_mesh(args.mesh)
            except ValueError as e:
                ap.error(f"{e}, or none|single|multi")
        init_distributed(device.type)
        mesh = build_device_mesh(spec, device.type)
        ctx = make_ctx(cfg, mesh, SHAPES["train_4k"])
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())

    tcfg = TrainConfig(
        steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        lr=args.lr, grad_accum=args.grad_accum, seed=args.seed,
        schedule=cfg.schedule, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        checkpoint_lean=args.checkpoint_lean,
        qn_dtype=args.qn_dtype or cfg.deq.qn_dtype,
        zero1=ctx.mesh is not None,
        **({"skip_budget": args.skip_budget}
           if args.skip_budget is not None else {}))

    trainer = Trainer(cfg, tcfg, device=device, ctx=ctx)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    n_params = sum(math.prod(d.shape) for d in tree_leaves(
        lm.model_decl(cfg)))
    if trainer.is_main:
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
              f"deq={cfg.deq.enabled} "
              + (f"backward={cfg.deq.backward} " if cfg.deq.enabled
                 else f"remat={cfg.remat} ")
              + f"device={where}"
              + (f" mesh={dict(ctx.mesh.shape)}" if ctx.mesh else ""))
    batches = make_lm_batch_iterator(cfg, args.batch, args.seq,
                                     seed=args.seed, device=device, ctx=ctx)
    state = trainer.run(batches, steps=args.steps)
    if trainer.is_main:
        print(f"finished at step {int(state.step)}")

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
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
