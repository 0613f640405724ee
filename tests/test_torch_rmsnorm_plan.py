"""The rmsnorm kernel's launch plan (``kernels/rmsnorm.plan``), on the CPU.

The plan picks the kernel instance and the grid in plain Python; the
kernel assigns rows to the row groups of its blocks by a grid-stride
loop.  Held here: every row is taken by exactly one row group, and no
block starts past the last row; the registered configs' widths take the
vector kernel with ``per * wpr * 256 = D`` in bf16 (``* 128`` in f32),
one warp a row for many bf16 rows up to 3072 and at most 3 vectors a lane
for few rows; any other width, or a row that is not 16-byte aligned, the
generic kernel; the splits the plan names are the ones the CUDA source
instantiates.
"""

import re

import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as rms


def _rows_of_each_group(p: rms.Plan, rows: int) -> list[list[int]]:
    """The rows each row group of the grid normalizes, as the kernels walk
    them: group g of block b takes rows b * R + g, then + gridDim * R."""
    r = p.rows_per_block
    return [list(range(b * r + g, rows, p.n_cta * r))
            for b in range(p.n_cta) for g in range(r)]


@pytest.mark.parametrize("rows", [1, 4, 31, 131, 132, 527, 1000, 1024, 2112,
                                  5000, 70001])
@pytest.mark.parametrize("d,dtype", [(2304, torch.bfloat16),
                                     (6144, torch.bfloat16),
                                     (2304, torch.float32),
                                     (64, torch.bfloat16)])
def test_every_row_once(rows, d, dtype):
    p = rms.plan(rows, d, dtype)
    taken = sorted(r for rs in _rows_of_each_group(p, rows) for r in rs)
    assert taken == list(range(rows))
    assert p.threads % (32 * p.wpr) == 0 and p.threads <= 256
    assert p.n_cta <= rms.SMS * rms.CTAS_PER_SM
    assert (p.n_cta - 1) * p.rows_per_block < rows


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_registered_widths_take_the_vector_kernel(name):
    d = ARCHS[name].d_model
    many, few = (rms.plan(1024, d, torch.bfloat16),
                 rms.plan(4, d, torch.bfloat16))
    assert many.vpl * 256 == d == few.vpl * 256
    assert many.per <= rms.MAX_PER and few.per <= rms.FEW_PER
    assert many.wpr == (1 if d <= 3072 else 2)
    assert rms.plan(1024, d, torch.float32).vpl * 128 == d
    assert rms.plan(4, d, torch.bfloat16, aligned=False).per == 0


@pytest.mark.parametrize("rows", [4, 131, 1000, 4000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hubert_width_takes_its_vector_instances(rows, dtype):
    """d 1280 (HuBERT-XLarge): 5 bf16 vectors a lane of one warp, 10 in
    f32.  Many rows take one warp a row (``(5, 1)``, ``(10, 1)``), few rows
    spread a row over 5 warps (``(1, 5)``, ``(2, 5)``); every row taken
    once."""
    p = rms.plan(rows, 1280, dtype)
    bf16 = dtype == torch.bfloat16
    want = ((5, 1) if bf16 else (10, 1)) if rows >= rms.SMS else \
        ((1, 5) if bf16 else (2, 5))
    assert (p.per, p.wpr) == want
    assert p.vpl * (256 if bf16 else 128) == 1280
    taken = sorted(r for rs in _rows_of_each_group(p, rows) for r in rs)
    assert taken == list(range(rows))


@pytest.mark.parametrize("rows", [4, 1024, 2304, 3072])
def test_pixtral_width_takes_its_vector_instances(rows):
    """d 5120 (Pixtral-12B's, Zamba2's gated norm): bf16 ``(10, 2)`` for
    many rows and ``(2, 10)`` for few (10 warps, 320 threads, one row a
    block: the one instance past 8 warps); f32 ``(10, 4)``."""
    p = rms.plan(rows, 5120, torch.bfloat16)
    assert (p.per, p.wpr) == ((10, 2) if rows >= rms.SMS else (2, 10))
    assert p.threads == (128 if rows >= rms.SMS else 320)
    assert (rms.plan(rows, 5120, torch.float32).per,
            rms.plan(rows, 5120, torch.float32).wpr) == (10, 4)
    taken = sorted(r for rs in _rows_of_each_group(p, rows) for r in rs)
    assert taken == list(range(rows))


@pytest.mark.parametrize("d", [64, 100, 1000, 1792, 2305, 2336, 3584])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_other_widths_take_the_generic_kernel(d, dtype):
    """Widths that are not a whole number of 16-byte vectors per lane, or
    that no instance splits (the instances are the registry's widths)."""
    p = rms.plan(1024, d, dtype)
    assert (p.per, p.wpr) == (0, 1)


def test_plan_names_only_instances_the_source_has():
    src = (build.CSRC / "rmsnorm.cu").read_text()
    splits = src.split("#define RMS_SPLITS(X)")[1].split("\n\n")[0]
    have = {(int(p), int(w))
            for p, w in re.findall(r"X\((\d+), (\d+)\)", splits)}
    assert have == set(rms.VEC_SPLITS)
    for rows in (4, 1024):  # the plan names only those
        for d in (1280, 2304, 2560, 3072, 5120, 6144):
            for dt in (torch.bfloat16, torch.float32):
                p = rms.plan(rows, d, dt)
                assert (p.per, p.wpr) in have
    assert "rmsnorm" in build.SOURCES
