"""The rmsnorm kernel against an earlier Triton rmsnorm and ``F.rms_norm``,
in turns, on one CUDA card.

    python3 tools/rmsnorm_timing.py --triton FILE

``FILE`` is a Triton source that defines ``rmsnorm_fwd(x_ptr, w_ptr,
out_ptr, D, eps, BLOCK)``, one program per row, e.g. the port's
``csrc/rmsnorm_triton.py`` of an earlier commit, unpacked with ``git
archive`` under the gitignored ``build/``.  It is launched as its wrapper
launched it: ``BLOCK`` the next power of two at or above ``D``, 8 warps
from a block of 2048 on, else 4.

At each bf16 shape of ``chip_smoke.RMS_SHAPES`` the three are checked
against the plain version, then timed (profiler device time per call) in
the order CUDA, Triton, library, library, Triton, CUDA: first each call
after an L2 flush (``device_ms``: x comes from HBM, as the byte bound
counts it), then back to back (``device_ms_warm``: x stays in the L2).
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--triton", required=True,
                    help="the Triton rmsnorm source to time beside the "
                    "CUDA kernel")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("rmsnorm_timing: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("rmsnorm_triton_src",
                                                  args.triton)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def triton_rmsnorm(x, w, eps):
        d = x.shape[-1]
        out = torch.empty_like(x)
        block = 1 << max(0, (d - 1).bit_length())
        mod.rmsnorm_fwd[(x.shape[0],)](x, w, out, d, float(eps), BLOCK=block,
                                       num_warps=8 if block >= 2048 else 4)
        return out

    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps, rows_out = 1e-5, {}
    for rows, d in cs.RMS_SHAPES:
        x = torch.randn(rows, d, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(
            torch.bfloat16)
        arms = {"cuda": lambda: cs.cuda_rms.rmsnorm(x, w, eps),
                "triton": lambda: triton_rmsnorm(x, w, eps),
                "library": lambda: F.rms_norm(x, (d,), w, eps)}
        want = cs.ref.rmsnorm_ref(x, w, eps)
        err = {k: cs.check_close(f"{k}[{rows}x{d}]", fn(), want, cs.TOL_BF16)
               for k, fn in arms.items()}
        order = ("cuda", "triton", "library", "library", "triton", "cuda")
        cold, warm = {k: [] for k in arms}, {k: [] for k in arms}
        for k in order:
            cold[k].append(sum(cs.device_profile(
                cs._cold(arms[k]), exclude=cs.FLUSH_KERNEL).values()))
        for k in order:
            warm[k].append(cs.device_ms(arms[k]))
        b_ms, b_by = cs.bound(2 * rows * d * 2 + d * 2, 4 * rows * d, "f32")
        rows_out[f"{rows}x{d} bf16"] = {
            "device_ms": {k: min(v) for k, v in cold.items()},
            "device_ms_warm": {k: min(v) for k, v in warm.items()},
            "turns_device_ms": cold, "turns_device_ms_warm": warm,
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps({"rmsnorm_timing": rows_out, "triton": args.triton,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
