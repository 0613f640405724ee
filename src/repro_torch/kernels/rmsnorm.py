"""Wrapper of the Triton RMSNorm kernel (``csrc/rmsnorm_triton.py``).

Replaces ``rmsnorm_pallas`` (``repro/kernels/rmsnorm.py``).  ``triton`` is
imported, and the kernel compiled, only inside :func:`rmsnorm` -- at the
first launch on the card, never at import.
"""

from __future__ import annotations

import importlib.util

import torch

from repro_torch.kernels import build, launches

_MODULE = None


def _kernel():
    global _MODULE
    if _MODULE is None:
        path = build.CSRC / "rmsnorm_triton.py"
        spec = importlib.util.spec_from_file_location(
            "repro_torch_csrc_rmsnorm_triton", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULE = mod
    return _MODULE.rmsnorm_fwd


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x (..., D)`` f32/bf16 on the card, ``weight (D,)``; f32 math, out in
    ``x.dtype``."""
    if not (x.is_cuda and weight.is_cuda):
        raise ValueError("rmsnorm kernel takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm takes float32/bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if tuple(weight.shape) != (d,):
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("rmsnorm takes a contiguous x")
    w = weight.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    block = triton_block(d)
    if rows:
        _kernel()[(rows,)](x2, w, out, d, float(eps), BLOCK=block,
                           num_warps=8 if block >= 2048 else 4)
        launches.bump("rmsnorm")
    return out.reshape(x.shape)


def triton_block(d: int) -> int:
    """The row tile: the next power of two at or above ``d``."""
    return 1 << max(0, (d - 1).bit_length())
