"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 chipbench/readings.py --workload <name> --program <seeds> \\
        --control <seeds> --faults <seeds> [--out FILE]

For each seed: ``program`` runs the program's set-up and checked steps
(no window) and the reference after them; ``control`` puts the fp8
reference in the program's place; ``faults`` runs the program with each
fault of ``chipbench/faults.py`` planted.  Every reading is printed as a
JSON line (and appended to ``--out``): the numbers ``correct`` compares.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chipbench import harness  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.boot()
    import torch

    from chipbench import faults, train

    cell = harness.Cell(harness.load_manifest(), args.workload)
    harness.require_chips(cell.chips)
    dev = torch.device("cuda")

    def say(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    def pick(n):
        keep = train.NUMBERS + ("diff_worst", "loss_steps", "gnorm_steps",
                                "grad_worst", "update_worst")
        return {k: n[k] for k in keep}

    for seed in _seeds(args.program):
        t0 = time.perf_counter()
        rec = train.run_program(cell, seed, 0.0, False, dev)
        n, ref = train.check(cell, seed, rec, dev)
        say(kind="program", workload=cell.name, seed=seed,
            seconds=time.perf_counter() - t0,
            iters=[rec["readings"]["iters"], ref["iters"]], **pick(n))
    for seed in _seeds(args.control):
        t0 = time.perf_counter()
        low = train.reference_readings(cell, seed, dev, quant="fp8")
        ref = train.reference_readings(cell, seed, dev,
                                       against=low.pop("grad_host"),
                                       follow=low["iters"] or None)
        say(kind="control", workload=cell.name, seed=seed,
            seconds=time.perf_counter() - t0, iters=[low["iters"],
                                                    ref["iters"]],
            **pick(train.compare(low, ref)))
    for seed in _seeds(args.faults):
        for name, fault in faults.FAULTS.items():
            with fault():
                rec = train.run_program(cell, seed, 0.0, False, dev)
            say(kind="fault", fault=name, workload=cell.name, seed=seed,
                **pick(train.check(cell, seed, rec, dev)[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
