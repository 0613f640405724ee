"""The Hopper kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (``sm_90a``), ``nvcc`` and Triton; they skip
elsewhere.  The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs with

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py

Shapes are small but ragged (D not a multiple of 4, S not a multiple of the
query tile, GQA, an empty ring row, a refused append) so each kernel's edge
handling is exercised; ``chip_smoke.py`` checks the serving path's shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launches
from repro_torch.kernels import ops
from repro_torch.kernels import ref

TOL = {torch.float32: dict(rtol=1e-3, atol=1e-3),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA/Triton kernels run only "
                    "on the card")
    launches.reset()
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qn_kernels_match_plain_versions(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    m, bsz, dim = 8, 5, 1030
    u = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    v = (0.3 * torch.randn(m, bsz, dim, device=dev, generator=gen)).to(dtype)
    g = torch.randn(bsz, dim, device=dev, generator=gen)
    s = 0.1 * torch.randn(bsz, dim, device=dev, generator=gen)
    s[3] = 0.0  # den = 0: the append is refused
    hg = torch.randn(bsz, dim, device=dev, generator=gen)
    count = torch.tensor([m + 2, 2, m, 0, 5], device=dev, dtype=torch.int32)
    mask = (torch.arange(m, device=dev)[:, None]
            < torch.clamp(count, max=m)[None]).float()
    slot = (count % m).int()
    active = torch.tensor([True, True, False, True, True], device=dev)
    alpha = torch.tensor(1.0, device=dev)
    want = ref.broyden_step_ref(u, v, g, s, hg, alpha, mask, slot, active,
                                1e-8)
    got = ops.broyden_step(u.clone(), v.clone(), g, s, hg, alpha, mask,
                           slot, active, 1e-8)
    for gt, wt in zip(got, want):
        _close(gt, wt, gt.dtype)
    xs = torch.stack([g, s, hg])
    flags = (False, True, False)
    _close(ops.qn_apply_multi(u, v, xs, alpha, mask, flags),
           ref.qn_apply_multi_ref(u, v, xs, alpha, mask, flags),
           torch.float32)
    c = launches.counts()
    assert c["broyden_step"] == 1 and c["qn_apply_multi"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64])
def test_attention_kernels_match_plain_versions(dev, dtype, hd):
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, h, kv = 2, 70, 4, 2
    q = torch.randn(b, s, h, hd, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, s, kv, hd, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, s, kv, hd, device=dev, generator=gen).to(dtype)
    lens = torch.tensor([70, 33], device=dev, dtype=torch.int32)
    _close(ops.attention(q, k, v, causal=True, kv_length=lens),
           ref.attention_ref(q, k, v, causal=True, kv_length=lens), dtype)
    dl = torch.tensor([1, 0], device=dev, dtype=torch.int32)  # 0: all masked
    _close(ops.decode_attention(q[:, 0], k, v, dl),
           ref.decode_attention_ref(q[:, 0], k, v, dl), dtype)
    c = launches.counts()
    assert c["flash_attention"] == 1 and c["decode_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_version(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(33, 2304, device=dev, generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(2304, device=dev, generator=gen)).to(dtype)
    _close(ops.rmsnorm(x, w, 1e-5), ref.rmsnorm_ref(x, w, 1e-5), dtype)
    assert launches.counts()["rmsnorm"] == 1


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(dev):
    from repro_torch.kernels import flash_attention, qn_apply
    u = torch.zeros(40, 2, 8, device=dev)
    with pytest.raises(ValueError):  # ring memory past the kernel's bound
        qn_apply.qn_apply_multi(u, u, torch.zeros(1, 2, 8, device=dev), 1.0,
                                torch.zeros(40, 2, device=dev), (False,))
    q = torch.zeros(1, 4, 2, 48, device=dev)
    with pytest.raises(ValueError):  # head dim not instantiated
        flash_attention.flash_attention(q, q, q)
