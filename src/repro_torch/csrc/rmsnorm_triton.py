"""Triton RMSNorm kernel for Hopper.

Replaces ``rmsnorm_pallas`` (``repro/kernels/rmsnorm.py``,
``_rmsnorm_kernel``): ``x * rsqrt(mean(x^2) + eps) * w`` with the reduction,
the normalization and the scale all in f32 and the result cast to the
activation dtype -- the Pallas kernel's precision.  (The plain version,
``repro_torch.kernels.ref.rmsnorm_ref``, follows the JAX oracle and applies
the scale in the activation dtype; at bf16 the two agree within the bf16
tolerance.)

What bounds it on the card: bytes -- one read of x and one write, ~3 flops
per element.  One program per row keeps the whole row (``BLOCK =
next_pow2(D)``, masked past D; 4096 for D = 2304) in registers, so x is
read from memory exactly once.

This file imports ``triton`` at the top, so it lives beside the CUDA sources
and is loaded by ``repro_torch.kernels.rmsnorm`` only when a kernel launches.
"""

import triton
import triton.language as tl


@triton.jit
def rmsnorm_fwd(x_ptr, w_ptr, out_ptr, D, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    msk = offs < D
    x = tl.load(x_ptr + row * D + offs, mask=msk, other=0.0).to(tl.float32)
    w = tl.load(w_ptr + offs, mask=msk, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    y = x * tl.rsqrt(var + eps) * w
    tl.store(out_ptr + row * D + offs, y.to(out_ptr.dtype.element_ty),
             mask=msk)
