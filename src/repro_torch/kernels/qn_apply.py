"""Wrappers of the Hopper quasi-Newton kernels (``csrc/qn_apply.cu``).

``qn_apply_multi`` replaces ``qn_apply_multi_pallas``, ``qn_apply`` (the
same kernel at K=1, counted under its own name) ``qn_apply_pallas``,
``broyden_step`` replaces ``broyden_step_pallas`` and ``lowrank_append``
replaces ``lowrank_append_pallas`` (``repro/kernels/qn_apply.py``).  All take
flattened ``(m, B, D)`` rings on the card; ``kernels/ops.py`` flattens the
feature axes and dispatches here only for CUDA tensors.  Each wrapper checks
device, dtype, shape and contiguity, allocates the outputs (and, for a
cooperative launch, the partial-sum scratch), launches on the current
stream, raises on a launch error and bumps its launch count.

``plan`` decides how ``qn_apply_multi`` and ``broyden_step`` cut the
flattened ``B*D`` axis over CTAs; it is pure Python, so the CPU tests check
it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, launches

MAX_MEMORY = 32
MAX_RHS = 4
_RING_DTYPES = (torch.float32, torch.bfloat16)

# Tiles in flight per CTA (fewer than its buffers).  The dynamic shared
# memory a streaming CTA's tile buffers may take: two CTAs per SM, each
# with its static scratch and the 1 KB the card reserves per CTA, within
# the SM's 228 KB (csrc/qn_apply.cu allows up to 220 KB for one; at the
# prefill shape one CTA per SM with twice the buffers was no faster).  The
# co-resident CTAs assumed where no card is asked: 132 SMs x 2.
PREFETCH = 3
SMEM_BUDGET = 110 * 1024
H100_CTAS = 264
# streaming: the bytes of phase-1 tiles marked evict_last in the 50 MB L2
# (the tiles just before those that stay in shared memory, which phase 2
# reads next); every other load is marked evict_first, which alone made
# qn_apply_multi faster at the prefill shape (PERF.md).
L2_KEEP_BYTES = 24 << 20
# resident schedule: elements per CTA of a sample's cluster, and the
# largest cluster (the portable limit)
RESIDENT_SLICE = 512
MAX_CLUSTER = 8
# lowrank_append: d-elements per block of its (chunks, B) grid
APPEND_CHUNK = 8192


def template_memory(m: int) -> int:
    """The kernel's compile-time ring bound for ``m`` rows (8, 16, 32)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call cuts its ring over CTAs (see :func:`slices`)."""

    schedule: str    # "resident" or "streaming"
    tile: int        # elements per tile: 1024 / template_memory(m) threads
    #                  x (16 / itemsize)
    vec: int         # elements per 16-byte chunk of the ring
    nbuf: int        # tile buffers in shared memory
    pref: int        # tiles in flight (< nbuf)
    l2_tiles: int    # phase-1 tiles marked evict_last in the L2
    smem: int        # the buffers' bytes
    n_cta: int
    slice: int       # elements per CTA
    cluster: int     # CTAs per sample, or 0: a flat cut of B*D
    coop: bool       # a flat cut: partials exchanged at a grid barrier
    partials: int    # f32 partial sums per (sample, CTA)


def slices(p: Plan, bsz: int, dim: int) -> list[tuple[int, int]]:
    """``[f0, f1)`` of the flattened ``B*D`` axis that each CTA owns, as
    the kernel computes it."""
    if not p.cluster:
        return [(c * p.slice, min((c + 1) * p.slice, bsz * dim))
                for c in range(p.n_cta)]
    out = []
    for c in range(p.n_cta):
        b, r = divmod(c, p.cluster)
        end = (b + 1) * dim
        f0 = min(b * dim + r * p.slice, end)
        out.append((f0, min(f0 + p.slice, end)))
    return out


def tile_layout(op: str, m: int, itemsize: int, k: int = 1):
    """``(tile, vec, nbuf, stage bytes)`` of ``op`` (``"qn"`` or
    ``"broyden"``): a tile holds m u rows, m v rows and ``k`` (qn) or 3
    (broyden: g, s, hg) f32 vectors; as many tiles as fit in SMEM_BUDGET."""
    vec = 16 // itemsize
    tile = 1024 // template_memory(m) * vec
    nvec = 3 if op == "broyden" else k
    stage = 2 * m * tile * itemsize + nvec * tile * 4
    return tile, vec, SMEM_BUDGET // stage, stage


@functools.lru_cache(maxsize=256)
def plan(op: str, m: int, bsz: int, dim: int, itemsize: int, k: int = 1,
         ctas: int = H100_CTAS) -> Plan:
    """The schedule of one ``op`` call (``"qn"`` or ``"broyden"``) on an
    ``(m, B, D)`` ring of ``itemsize``-byte elements with ``k`` right-hand
    sides, given the ``ctas`` the cooperative kernel can hold co-resident.

    * resident, where one sample spreads over at most MAX_CLUSTER CTAs of
      RESIDENT_SLICE elements (D <= 4096; the decode shape D = 2304): one
      thread-block cluster per sample, each CTA's slice held whole in its
      shared memory, every byte read once, the partials summed through the
      cluster's shared memory, no scratch and no grid barrier.  Above that
      threshold the ring no longer fits the few SMs of one cluster per
      sample and the launch is about bandwidth, not latency: four samples
      would hold at most 32 of the 132 SMs;
    * streaming, else: ``ctas`` equal slices of ``B*D``, each a multiple of
      the 16-byte vector, so at most two samples each (a slice is at most D
      long), with the partials exchanged at one grid barrier.  Where that
      slice would exceed D (B above ``ctas``), each sample is its own slice
      and no partial crosses a CTA.
    """
    tile, vec, nbuf, stage = tile_layout(op, m, itemsize, k)
    if nbuf < 2:
        raise ValueError(f"{op}: two tiles of m={m} rows exceed shared memory")
    kt = 1 if k == 1 else MAX_RHS
    partials = (2 * template_memory(m) + 2 if op == "broyden"
                else kt * template_memory(m))
    common = dict(tile=tile, vec=vec, partials=partials)
    # a resident CTA holds its whole slice: at most nbuf tiles of it
    cluster = -(-dim // min(RESIDENT_SLICE, nbuf * tile))
    if cluster <= MAX_CLUSTER:
        slc = -(-(-(-dim // cluster)) // vec) * vec
        cluster = -(-dim // slc)
        ntile = -(-slc // tile)
        pref = min(PREFETCH, max(1, ntile - 1))
        nb = max(ntile, pref + 1)
        return Plan("resident", nbuf=nb, pref=pref, l2_tiles=0,
                    smem=nb * stage,
                    n_cta=bsz * cluster, slice=slc, cluster=cluster,
                    coop=False, **common)
    common.update(nbuf=nbuf, pref=min(PREFETCH, nbuf - 1), smem=nbuf * stage)
    # phase 1 reads all of a broyden tile, and of a qn tile its k vectors
    # and m coefficient rows (2m with mixed flags; the window is a hint)
    rows = 2 * m if op == "broyden" else m
    read1 = rows * tile * itemsize + (3 if op == "broyden" else k) * tile * 4
    total = bsz * dim
    slc = -(-(-(-total // ctas)) // vec) * vec
    if slc > dim:
        n_cta, slc, cluster, coop = bsz, dim, 1, False
    else:
        n_cta, slc, cluster, coop = -(-total // slc), slc, 0, True
    return Plan("streaming", n_cta=n_cta, slice=slc, cluster=cluster,
                coop=coop, l2_tiles=L2_KEEP_BYTES // (n_cta * read1),
                **common)


@functools.lru_cache(maxsize=64)
def _coop_ctas(op: str, bf16: bool, m: int, k: int, vec: bool,
               nbuf: int) -> int:
    """The co-resident CTAs of the stream kernel on this card (SMs x the
    CTAs per SM its occupancy allows), asked once per kernel and layout."""
    import ctypes
    out = ctypes.c_int(0)
    err = build.library("qn_apply").qn_stream_ctas(
        int(op == "broyden"), int(bf16), m, k, int(vec), nbuf,
        ctypes.byref(out))
    build.check(err, f"{op} occupancy")
    return out.value


def _plan_call(op, u, bsz, dim, k, vec):
    m = u.shape[0]
    itemsize = u.element_size()
    nbuf = tile_layout(op, m, itemsize, k)[2]
    ctas = _coop_ctas(op, u.dtype == torch.bfloat16, m, k, vec, nbuf)
    return plan(op, m, bsz, dim, itemsize, k, ctas)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_ring(u: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor | None = None):
    _require(u.is_cuda and v.is_cuda, "qN kernels take CUDA tensors")
    _require(u.ndim == 3 and u.shape == v.shape,
             f"u/v must be matching (m, B, D); got {tuple(u.shape)}, "
             f"{tuple(v.shape)}")
    _require(u.dtype == v.dtype and u.dtype in _RING_DTYPES,
             f"ring dtype must be float32 or bfloat16; got {u.dtype}")
    _require(u.is_contiguous() and v.is_contiguous(), "u/v must be contiguous")
    m, bsz, _ = u.shape
    _require(1 <= m <= MAX_MEMORY, f"ring memory {m} outside 1..{MAX_MEMORY}")
    _require(mask is None or tuple(mask.shape) == (m, bsz),
             f"mask must be {(m, bsz)}")


def _f32(x: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _scratch(p: Plan, bsz: int, dev):
    """The (B, n_cta, P) partial sums of a cooperative launch, else none."""
    if not p.coop:
        return None
    return torch.empty((bsz, p.n_cta, p.partials), dtype=torch.float32,
                       device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def qn_apply_multi(u, v, xs, alpha, mask, transpose) -> torch.Tensor:
    """``out[k] = (H^T if transpose[k] else H) @ xs[k]``; u/v ``(m, B, D)``,
    xs ``(K, B, D)``; returns ``(K, B, D)`` in ``xs.dtype``."""
    out = _launch_multi(u, v, xs, alpha, mask, transpose)
    launches.bump("qn_apply_multi")
    return out


def qn_apply(u, v, x, alpha, mask) -> torch.Tensor:
    """``H @ x`` for one right-hand side ``x (B, D)``: the ``qn_apply_multi``
    kernel at K=1, ``(False,)``.  Returns ``(B, D)`` in ``x.dtype``."""
    out = _launch_multi(u, v, x[None], alpha, mask, (False,))
    launches.bump("qn_apply")
    return out[0]


def _launch_multi(u, v, xs, alpha, mask, transpose) -> torch.Tensor:
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
    out = torch.empty((kk, bsz, dim), dtype=torch.float32, device=dev)
    tmask = sum(1 << k for k, t in enumerate(transpose) if t)
    vec = dim % (16 // u.element_size()) == 0 and _aligned(u, v, xs32, out)
    p = _plan_call("qn", u, bsz, dim, kk, vec)
    partial = _scratch(p, bsz, dev)
    err = build.library("qn_apply").qn_apply_multi_launch(
        u.data_ptr(), v.data_ptr(), xs32.data_ptr(), mask32.data_ptr(),
        alpha32.data_ptr(), _ptr(partial), out.data_ptr(), m, bsz, dim, kk,
        tmask, p.n_cta, p.slice, p.cluster, p.nbuf, p.pref, p.l2_tiles, int(p.coop),
        int(u.dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "qn_apply_multi")
    return out if xs.dtype == torch.float32 else out.to(xs.dtype)


def _flags(active: torch.Tensor, dev) -> torch.Tensor:
    """``active`` as the kernel reads it, one byte per row: a bool tensor
    as it comes (a view, no launch), anything else as ``active > 0.5``."""
    act = torch.as_tensor(active, device=dev)
    if act.dtype != torch.bool:
        act = act.float() > 0.5
    return act.contiguous().view(torch.uint8)


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
    act8 = _flags(active, dev)
    _require(tuple(slot32.shape) == (bsz,) and tuple(act8.shape) == (bsz,),
             f"slot/active must be ({bsz},)")
    f32 = dict(dtype=torch.float32, device=dev)
    hg_new = torch.empty((bsz, dim), **f32)
    b = torch.empty((bsz, dim), **f32)
    den = torch.empty((bsz,), **f32)
    ev_u = torch.empty((bsz, dim), dtype=u.dtype, device=dev)
    ev_v = torch.empty_like(ev_u)
    vec = dim % (16 // u.element_size()) == 0 and _aligned(
        u, v, g32, s32, hg32, hg_new, b, ev_u, ev_v)
    p = _plan_call("broyden", u, bsz, dim, 1, vec)
    partial = _scratch(p, bsz, dev)
    err = build.library("qn_apply").broyden_step_launch(
        u.data_ptr(), v.data_ptr(), g32.data_ptr(), s32.data_ptr(),
        hg32.data_ptr(), mask32.data_ptr(), slot32.data_ptr(),
        act8.data_ptr(), alpha32.data_ptr(), float(eps), _ptr(partial),
        hg_new.data_ptr(), b.data_ptr(), den.data_ptr(), ev_u.data_ptr(),
        ev_v.data_ptr(), m, bsz, dim, p.n_cta, p.slice, p.cluster, p.nbuf,
        p.pref, p.l2_tiles, int(p.coop),
        int(u.dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "broyden_step")
    launches.bump("broyden_step")
    return u, v, hg_new, b, den, ev_u, ev_v


def lowrank_append(u, v, s, hy, b, inv_den, slot, upd):
    """Write ``a = (s - hy) * inv_den`` and ``b`` into ring row ``slot[b]``
    where ``upd[b]``, on the card.  ``u``/``v`` ``(m, B, D)`` are updated IN
    PLACE and returned (callers treat the inputs as consumed); returns
    ``(u, v, ev_u, ev_v)`` with the slot's previous rows, as
    ``repro_torch.kernels.ref.lowrank_append_ref`` does."""
    _check_ring(u, v)
    m, bsz, dim = u.shape
    dev = u.device
    for name, t in (("s", s), ("hy", hy), ("b", b)):
        _require(tuple(t.shape) == (bsz, dim) and t.is_cuda,
                 f"{name} must be ({bsz}, {dim}) on the card")
    s32, hy32, b32 = _f32(s, dev), _f32(hy, dev), _f32(b, dev)
    inv32, upd32 = _f32(inv_den, dev), _f32(upd, dev)
    slot32 = torch.as_tensor(slot, dtype=torch.int32, device=dev).contiguous()
    _require(tuple(inv32.shape) == (bsz,) and tuple(upd32.shape) == (bsz,)
             and tuple(slot32.shape) == (bsz,),
             f"inv_den/slot/upd must be ({bsz},)")
    chunk = min(APPEND_CHUNK, (dim + 3) // 4 * 4)
    nchunks = -(-dim // chunk)
    ev_u = torch.empty((bsz, dim), dtype=u.dtype, device=dev)
    ev_v = torch.empty_like(ev_u)
    vec = dim % 4 == 0 and _aligned(u, v, s32, hy32, b32, ev_u, ev_v)
    err = build.library("qn_apply").lowrank_append_launch(
        u.data_ptr(), v.data_ptr(), s32.data_ptr(), hy32.data_ptr(),
        b32.data_ptr(), inv32.data_ptr(), slot32.data_ptr(), upd32.data_ptr(),
        ev_u.data_ptr(), ev_v.data_ptr(), m, bsz, dim, chunk, nchunks,
        int(u.dtype == torch.bfloat16), int(vec),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "lowrank_append")
    launches.bump("lowrank_append")
    return u, v, ev_u, ev_v
