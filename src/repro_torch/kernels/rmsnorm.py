"""Wrapper of the Hopper RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``rmsnorm_pallas`` (``repro/kernels/rmsnorm.py``).  :func:`plan`
picks the kernel instance and the grid in plain Python, so the CPU tests
hold it: for the registry's widths a row is ``per`` 16-byte vectors per
lane over ``wpr`` warps (``D = per * wpr * 256`` in bf16, ``* 128`` in
f32), a grid-stride loop over rows; any other width takes the generic
kernel, one warp per row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, launches

# the (per, wpr) instances of rmsnorm_vec_kernel (RMS_SPLITS in the source),
# for both dtypes: per 16-byte vectors per lane over wpr warps a row
VEC_SPLITS = ((9, 1), (10, 1), (12, 1), (9, 2), (10, 2), (12, 2), (12, 4),
              (2, 5), (3, 3), (3, 4), (3, 6), (3, 8), (8, 1), (2, 4), (8, 2),
              (2, 1), (5, 1), (1, 5), (2, 10), (10, 4))
MAX_PER = 12       # a row's vectors in one warp's registers at most
FEW_PER = 3        # a lane's vectors when rows are few
SMS = 132          # an H100 SXM's streaming multiprocessors
CTAS_PER_SM = 4    # grid cap, then the rows loop
_DTYPES = (torch.float32, torch.bfloat16)


class Plan(NamedTuple):
    per: int      # 16-byte vectors per lane; 0 = the generic kernel
    wpr: int      # warps per row
    n_cta: int    # blocks
    threads: int  # threads per block

    @property
    def vpl(self) -> int:
        """A row's vectors per lane of one warp (``per * wpr``)."""
        return self.per * self.wpr

    @property
    def rows_per_block(self) -> int:
        return self.threads // (32 * self.wpr)


def plan(rows: int, d: int, dtype: torch.dtype, *, aligned: bool = True,
         n_sm: int = SMS) -> Plan:
    """The launch for ``rows`` rows of width ``d``.  A width of ``VPL``
    whole 16-byte vectors per lane of a warp, 16-byte ``aligned``, takes the
    vector kernel with ``VPL = per * wpr``: with rows to fill the card
    (``rows >= n_sm``) the fewest warps a row that keep ``per <= MAX_PER``,
    4 warps a block; with fewer rows the warps that bring ``per`` to
    ``FEW_PER`` or below, one row a block.  Any other width takes the
    generic kernel, one warp per row, 4 warps a block.  The grid holds at
    most ``CTAS_PER_SM`` blocks a SM; the blocks loop over the rest."""
    per_vec = 16 // dtype.itemsize
    vpl = d // (32 * per_vec) if d % (32 * per_vec) == 0 else 0
    splits = sorted((w, p) for p, w in VEC_SPLITS if p * w == vpl)
    cap = MAX_PER if rows >= n_sm else FEW_PER
    # the fewest warps within the cap; few rows with no split that small
    # take the fewest warps there are
    wpr = next((w for w, p in splits if p <= cap),
               splits[0][0] if splits and rows < n_sm else None)
    if not aligned or not vpl or wpr is None:
        per, wpr = 0, 1
    else:
        per = vpl // wpr
    rpb = max(1, 4 // wpr) if rows >= n_sm or per == 0 else 1
    n_cta = max(1, min(-(-rows // rpb), n_sm * CTAS_PER_SM))
    return Plan(per, wpr, n_cta, 32 * wpr * rpb)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x (..., D)`` f32/bf16 on the card, ``weight (D,)`` of x's dtype; f32
    math, out in ``x.dtype``."""
    if not (x.is_cuda and weight.is_cuda):
        raise ValueError("rmsnorm kernel takes CUDA tensors")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise ValueError(f"rmsnorm takes float32/bfloat16 x and a weight of "
                         f"its dtype, got {x.dtype} and {weight.dtype}")
    d = x.shape[-1]
    if tuple(weight.shape) != (d,):
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("rmsnorm takes a contiguous x")
    w = weight.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows and d:
        p = plan(rows, d, x.dtype, aligned=all(
            t.data_ptr() % 16 == 0 for t in (x2, w, out)),
            n_sm=torch.cuda.get_device_properties(x.device)
            .multi_processor_count)
        err = build.library("rmsnorm").rmsnorm_launch(
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
            int(x.dtype == torch.bfloat16), p.per, p.wpr, p.n_cta, p.threads,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "rmsnorm")
        launches.bump("rmsnorm")
    return out.reshape(x.shape)
