"""Cold-L2 times of the quasi-Newton kernels on one CUDA card.

    python3 tools/qn_timing.py                  # this checkout's src/
    python3 tools/qn_timing.py --src DIR        # the repro_torch package
                                                # under DIR, e.g. an
                                                # unpacked archive of
                                                # another commit
    python3 tools/qn_timing.py --one-cta-per-sample

Times ``broyden_step``, ``qn_apply_multi``, ``qn_apply`` and
``lowrank_append`` at the serving and training paths' two ring shapes
(m=8, B=4, bf16, D = 2304 and 256 x 2304) through the package's public
wrappers, with ``chip_smoke.py``'s harness (``time_qn_ops``: each call
after a 256 MB write that leaves the L2 cold; device times per kernel from
the profiler, the write left out).  To compare two commits, unpack one
beside the other and run old, new, new, old one after another on one card.

``--one-cta-per-sample`` times the decode shape (D = 2304) four times in
turn: with the resident schedule as ``plan`` gives it (a thread-block
cluster per sample), with one CTA per sample holding the sample's whole
ring slice, again with one CTA, again with the cluster.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the directory that holds repro_torch/")
    ap.add_argument("--one-cta-per-sample", action="store_true",
                    help="compare the decode shape's cluster per sample "
                    "with one CTA per sample")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    # the package under --src, imported before chip_smoke puts this
    # checkout's src/ first: chip_smoke's imports resolve to it
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("qn_timing: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.one_cta_per_sample:
        rows = {f"{name}[S={seq}]": r for seq in (1, 256)
                for name, r in cs.time_qn_ops(cs.qn_path_inputs(seq, gen)
                                              ).items()}
        print(json.dumps({"qn_timing": rows, "src": src, "card": smi}),
              flush=True)
        return 0
    qn = cs.cuda_qn
    inp = cs.qn_path_inputs(1, gen)
    cluster = (qn.RESIDENT_SLICE, qn.SMEM_BUDGET)
    # one CTA per sample: no cap on a resident CTA's slice, and a CTA's
    # tile buffers may take the whole of what the kernel allows
    one_cta = (1 << 30, 220 * 1024)
    out = {"cluster": [], "one_cta": []}
    for name, (slc, budget) in (("cluster", cluster), ("one_cta", one_cta),
                                ("one_cta", one_cta), ("cluster", cluster)):
        qn.RESIDENT_SLICE, qn.SMEM_BUDGET = slc, budget
        qn.plan.cache_clear()
        plans = {op: qn.plan(op, 8, 4, 2304, 2, 1, qn.H100_CTAS)
                 for op in ("broyden", "qn")}
        if name == "one_cta" and any(p.cluster != 1 or p.schedule
                                     != "resident" for p in plans.values()):
            raise AssertionError(f"not one CTA per sample: {plans}")
        rows = cs.time_qn_ops(inp)
        out[name].append({
            "plan": {op: f"{p.schedule} cluster={p.cluster} "
                     f"n_cta={p.n_cta} slice={p.slice} smem={p.smem}"
                     for op, p in plans.items()},
            "device_ms": {k: r["device_ms"] for k, r in rows.items()},
            "ms": {k: r["ms"] for k, r in rows.items()}})
    qn.RESIDENT_SLICE, qn.SMEM_BUDGET = cluster
    qn.plan.cache_clear()
    print(json.dumps({"resident_compare": out, "src": src, "card": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
