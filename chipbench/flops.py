"""The card's peaks, and the operations and bytes of the program's
kernels, from a call's shapes alone.

The yardstick of every share of a roofline, kept with the benchmark so
that a change to the program cannot move it (a model's operations, the
yardstick of a share of the peak, are its layout's:
``chipbench/layouts/<layout>.py``).  A kernel's bytes count each input
byte read once and each output byte written once; where the work depends
on the data (the ring slots a quasi-Newton call finds live), the count is
of what these inputs need.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of bytes over the
    memory's rate and operations over the dtype's peak."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["flops_per_s"][dtype])


def peak_flops(dtype: str = "bfloat16") -> float:
    return PEAKS["flops_per_s"][dtype]


# ---------------------------------------------------------------------------
# kernels (per call, from the call's arguments)
# ---------------------------------------------------------------------------


def attention_cost(b, s, t, h, kv, hd, itemsize, causal) -> tuple[float, float]:
    """``ops.attention`` forward: q, k, v read, out written; the score and
    value products over the key positions each query needs."""
    nbytes = itemsize * (2 * b * s * h * hd + 2 * b * t * kv * hd)
    pairs = s * (s + 1) / 2 + s * (t - s) if causal else s * t
    return nbytes, 4.0 * b * h * hd * pairs


def broyden_step_cost(live_pairs, b, dim, ring_itemsize
                      ) -> tuple[float, float]:
    """``ops.broyden_step``: the live ring pairs ``(u_i, v_i)`` read
    (``live_pairs`` summed over rows), g_new, s and H g_old read (f32);
    H g_new, b written (f32), the appended pair and the evicted one
    written in the ring's dtype; ``H g`` and ``H^T s`` over the live
    pairs."""
    vec = 4 * b * dim
    nbytes = (2 * live_pairs * dim * ring_itemsize + 3 * vec + 2 * vec
              + 4 * b * dim * ring_itemsize)
    return nbytes, 8.0 * live_pairs * dim


def qn_apply_multi_cost(live_pairs, b, dim, k, ring_itemsize, x_itemsize
                        ) -> tuple[float, float]:
    """``ops.qn_apply_multi`` over K right-hand sides: the live ring pairs
    read once, the K inputs read and outputs written."""
    nbytes = (2 * live_pairs * dim * ring_itemsize
              + 2 * k * b * dim * x_itemsize)
    return nbytes, 4.0 * k * live_pairs * dim
