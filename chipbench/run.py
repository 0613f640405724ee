"""Run one cell of the port's benchmark once.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``chipbench/``
and the program (``src/repro_torch``).  The cell is found by name in
``BENCHMARK.json``; the run sets up, warms up, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON object as its last line: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``), ``correct``, and
the card.  Without a CUDA card, or with fewer cards than the cell asks
for, it prints no result and exits 2; it exits 3, printing none, if JAX
or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chipbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.boot()
    try:
        cell = harness.Cell(harness.load_manifest(), args.workload)
        harness.require_chips(cell.chips)
        driver = harness.driver(cell)
    except (harness.Refused, OSError, KeyError, ValueError,
            ImportError) as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 2
    result, compared = driver.run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"chipbench: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 3
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
