"""Wrappers of the Hopper quasi-Newton kernels (``csrc/qn_apply.cu``).

``qn_apply_multi`` replaces ``qn_apply_multi_pallas`` and ``broyden_step``
replaces ``broyden_step_pallas`` (``repro/kernels/qn_apply.py``).  Both take
flattened ``(m, B, D)`` rings on the card; ``kernels/ops.py`` flattens the
feature axes and dispatches here only for CUDA tensors.  Each wrapper checks
device, dtype, shape and contiguity, allocates the outputs and the
partial-sum scratch, launches on the current stream, raises on a launch
error and bumps its launch count.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, launches

# d-elements per block: large enough that folding the (B, n_chunks, P)
# partials stays small next to the ring stream, small enough that a prefill
# ring (D = 256 * 2304) still spreads over several hundred blocks
CHUNK = 8192
MAX_MEMORY = 32
MAX_RHS = 4
_RING_DTYPES = (torch.float32, torch.bfloat16)


def _geometry(dim: int) -> tuple[int, int]:
    chunk = min(CHUNK, (dim + 3) // 4 * 4)
    return chunk, (dim + chunk - 1) // chunk


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_ring(u: torch.Tensor, v: torch.Tensor, mask: torch.Tensor):
    _require(u.is_cuda and v.is_cuda, "qN kernels take CUDA tensors")
    _require(u.ndim == 3 and u.shape == v.shape,
             f"u/v must be matching (m, B, D); got {tuple(u.shape)}, "
             f"{tuple(v.shape)}")
    _require(u.dtype == v.dtype and u.dtype in _RING_DTYPES,
             f"ring dtype must be float32 or bfloat16; got {u.dtype}")
    _require(u.is_contiguous() and v.is_contiguous(), "u/v must be contiguous")
    m, bsz, _ = u.shape
    _require(1 <= m <= MAX_MEMORY, f"ring memory {m} outside 1..{MAX_MEMORY}")
    _require(tuple(mask.shape) == (m, bsz), f"mask must be {(m, bsz)}")


def _f32(x: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def qn_apply_multi(u, v, xs, alpha, mask, transpose) -> torch.Tensor:
    """``out[k] = (H^T if transpose[k] else H) @ xs[k]``; u/v ``(m, B, D)``,
    xs ``(K, B, D)``; returns ``(K, B, D)`` in ``xs.dtype``."""
    _check_ring(u, v, mask)
    m, bsz, dim = u.shape
    kk = xs.shape[0]
    _require(tuple(xs.shape) == (kk, bsz, dim) and xs.is_cuda,
             f"xs must be (K, {bsz}, {dim}) on the card")
    _require(1 <= kk <= MAX_RHS and len(transpose) == kk,
             f"1..{MAX_RHS} right-hand sides with one flag each")
    dev = u.device
    xs32 = _f32(xs, dev)
    mask32 = _f32(mask, dev)
    alpha32 = _f32(alpha, dev).reshape(())
    chunk, nchunks = _geometry(dim)
    partial = torch.empty((bsz, nchunks, kk * m), dtype=torch.float32,
                          device=dev)
    out = torch.empty((kk, bsz, dim), dtype=torch.float32, device=dev)
    tmask = sum(1 << k for k, t in enumerate(transpose) if t)
    vec = dim % 4 == 0 and _aligned(u, v, xs32, out)
    err = build.library("qn_apply").qn_apply_multi_launch(
        u.data_ptr(), v.data_ptr(), xs32.data_ptr(), mask32.data_ptr(),
        alpha32.data_ptr(), partial.data_ptr(), out.data_ptr(), m, bsz, dim,
        kk, tmask, chunk, nchunks, int(u.dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "qn_apply_multi")
    launches.bump("qn_apply_multi")
    return out if xs.dtype == torch.float32 else out.to(xs.dtype)


def broyden_step(u, v, g_new, s, hg_old, alpha, mask, slot, active,
                 eps: float):
    """One Broyden iteration on the card.  ``u``/``v`` ``(m, B, D)`` are
    updated IN PLACE (the ring slot ``slot[b]`` receives the new pair where
    the update is taken) and returned; callers must treat the inputs as
    consumed.  Returns ``(u, v, hg_new, b, den, ev_u, ev_v)`` as
    ``repro_torch.kernels.ref.broyden_step_ref`` does."""
    _check_ring(u, v, mask)
    m, bsz, dim = u.shape
    dev = u.device
    for name, t in (("g_new", g_new), ("s", s), ("hg_old", hg_old)):
        _require(tuple(t.shape) == (bsz, dim) and t.is_cuda,
                 f"{name} must be ({bsz}, {dim}) on the card")
    g32, s32, hg32 = _f32(g_new, dev), _f32(s, dev), _f32(hg_old, dev)
    mask32 = _f32(mask, dev)
    alpha32 = _f32(alpha, dev).reshape(())
    slot32 = torch.as_tensor(slot, dtype=torch.int32, device=dev).contiguous()
    act32 = _f32(active, dev)
    _require(tuple(slot32.shape) == (bsz,) and tuple(act32.shape) == (bsz,),
             f"slot/active must be ({bsz},)")
    chunk, nchunks = _geometry(dim)
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty((bsz, nchunks, 2 * m + 2), **f32)
    hg_new = torch.empty((bsz, dim), **f32)
    b = torch.empty((bsz, dim), **f32)
    den = torch.empty((bsz,), **f32)
    ev_u = torch.empty((bsz, dim), dtype=u.dtype, device=dev)
    ev_v = torch.empty_like(ev_u)
    vec = dim % 4 == 0 and _aligned(u, v, g32, s32, hg32, hg_new, b, ev_u,
                                    ev_v)
    err = build.library("qn_apply").broyden_step_launch(
        u.data_ptr(), v.data_ptr(), g32.data_ptr(), s32.data_ptr(),
        hg32.data_ptr(), mask32.data_ptr(), slot32.data_ptr(),
        act32.data_ptr(), alpha32.data_ptr(), float(eps), partial.data_ptr(),
        hg_new.data_ptr(), b.data_ptr(), den.data_ptr(), ev_u.data_ptr(),
        ev_v.data_ptr(), m, bsz, dim, chunk, nchunks,
        int(u.dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "broyden_step")
    launches.bump("broyden_step")
    return u, v, hg_new, b, den, ev_u, ev_v
