"""Public kernel ops: dispatch by the device of the tensors.

    tensor device | executes
    --------------+-------------------------------------------------------
    cpu           | the plain PyTorch version (kernels/ref.py)
    cuda          | the hand-written Hopper kernel (csrc/), or it raises
    meta          | the CPU's route, on shapes only (the dry-run)

There is no other route and no fallback: a CUDA tensor never reaches a
plain version unless the caller asks for one (``attention``'s ``impl``),
and a failed build or launch raises.  (The JAX package's TPU sublane pad
of the ring memory axis has no counterpart here: the CUDA kernels mask the
ragged edges themselves.)

``attention`` also takes the JAX package's ``impl`` policy: ``auto`` (the
kernel on the card; on the CPU the plain version below ``FLASH_XLA_CELLS``
score cells and the chunked ``flash_xla`` path at or above them, where the
reference's CPU policy switches), ``flash_xla`` (the chunked path on
either device), ``ref`` (the plain version on either device), ``pallas``
(the Hopper kernel; CPU tensors raise) and ``pallas_interpret`` (the
reference's CPU stand-in for its kernel: the plain version, CPU tensors
only).

Ops: ``qn_apply`` (single-RHS ``H x``), ``qn_apply_multi`` (K stacked RHS,
per-RHS H vs H^T, one U/V stream), ``lowrank_append`` (the guarded ring-slot
write of a Broyden pair), ``broyden_step`` (one Broyden iteration's apply,
denominator and guarded ring append), ``attention``, ``decode_attention``,
``rmsnorm``.

Gradients: ``attention`` and ``rmsnorm`` are ``torch.autograd.Function``s
whose forward is the kernel (the plain version on the CPU) and whose
backward recomputes through the plain version from the saved inputs, as the
JAX package's custom VJPs do.  The qN ops run only inside the implicit
layer's forward and backward, so they need no gradient of their own.

Sharded tensors: given DTensors (a run on a ``DeviceMesh``), each op runs
on every rank's local shard through ``local_map`` with the placements the
reference's layouts imply, and every rank launches the same kernel (the
plain version on the CPU) on its shard.  ``attention``: batch over the DP
axes, heads over "model" (KV heads that do not divide stay whole and each
rank takes its query heads' groups); ``decode_attention``: the same, or
over a cache whose length is split (``DECODE_RULES``): each rank runs the
split-K launch on its slice with its lengths shifted by the slice's
offset, the per-row partials ``(m, l, acc)`` are gathered over that axis
and the combine launch merges them (a slice with no valid key adds ``l =
0``); ``rmsnorm``: rows split, the weight whole (its gradient a
``Partial`` sum over the axes that split the rows); ``qn_apply_multi``,
``broyden_step``: batch over the DP axes, no collective inside (the
reference's ``qn_apply_multi_sharded`` route).

Precision: the qN ring may be stored bf16; every path upcasts ring loads
and accumulates coefficients, denominators and outputs in f32.  The stream
counters (``qn_stream_stats``) count fused U/V passes and their analytic
bytes with the ring's real itemsize, and the ``qn_ring_bytes`` gauge
(labelled by dtype) records the resident ring footprint.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import flash_xla
from repro_torch.kernels import qn_apply as cuda_qn
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as cuda_rms
from repro_torch.obs import metrics as obs_metrics
from repro_torch.parallel.sharding import (
    as_dtensor,
    local_shard,
    shard_map_compat,
    shard_offset,
)


def _on_card(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors; False for CPU tensors, and for ``meta``
    tensors (the dry-run's shapes without storage take the CPU's routes:
    nothing on them is computed); any mix raises."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel ops take all-CPU, all-CUDA or all-meta "
                     f"tensors; got {sorted(kinds)}")


# ---------------------------------------------------------------------------
# qN stream statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QNStreamStats:
    """Counters of the qN inverse-application streaming cost: ``calls``
    fused U/V passes, ``rhs`` right-hand sides applied, ``uv_bytes`` the
    analytic ring bytes streamed.  Eager PyTorch records once per executed
    call (the JAX package records once per trace)."""

    calls: int = 0
    rhs: int = 0
    uv_bytes: int = 0


_QN_COUNTERS = ("qn_stream_calls", "qn_stream_rhs", "qn_stream_uv_bytes")


def reset_qn_stream_stats() -> None:
    reg = obs_metrics.default_registry()
    for name in _QN_COUNTERS:
        reg.counter(name).value = 0.0


def qn_stream_stats() -> QNStreamStats:
    reg = obs_metrics.default_registry()
    calls, rhs, uv_bytes = (int(reg.counter(n).value) for n in _QN_COUNTERS)
    return QNStreamStats(calls=calls, rhs=rhs, uv_bytes=uv_bytes)


def qn_stream_bytes(m: int, bsz: int, dim: int, itemsize: int,
                    transpose: Sequence[bool]) -> int:
    """Analytic U/V bytes one fused application streams: per phase
    (coefficient, apply) a buffer is read once iff some RHS needs it."""
    any_t, any_f = any(transpose), not all(transpose)
    streams = 2 * (int(any_t) + int(any_f))
    return streams * m * bsz * dim * itemsize


def _record_stream(u: torch.Tensor, transpose: Sequence[bool]) -> None:
    m, bsz = u.shape[0], u.shape[1]
    dim = u[0, 0].numel()
    reg = obs_metrics.default_registry()
    reg.counter("qn_stream_calls").inc()
    reg.counter("qn_stream_rhs").inc(len(transpose))
    reg.counter("qn_stream_uv_bytes").inc(
        qn_stream_bytes(m, bsz, dim, u.element_size(), transpose))
    reg.gauge("qn_ring_bytes", {"dtype": str(u.dtype).replace("torch.", "")}
              ).set(2 * m * bsz * dim * u.element_size())


# ---------------------------------------------------------------------------
# qN ops
# ---------------------------------------------------------------------------


def qn_apply_multi(u, v, xs, alpha, mask,
                   transpose: Sequence[bool] | None = None) -> torch.Tensor:
    """Apply H (and/or H^T, per ``transpose``) to the K stacked right-hand
    sides ``xs: (K, B, *F)`` in one streaming pass over U/V ``(m, B, *F)``.
    Returns ``(K, B, *F)`` in ``xs.dtype``."""
    kk = xs.shape[0]
    transpose = tuple(bool(t) for t in
                      ((False,) * kk if transpose is None else transpose))
    if len(transpose) != kk:
        raise ValueError(f"transpose has {len(transpose)} flags for {kk} RHS")
    if _sharded(u, v, xs, mask):
        return qn_apply_multi_sharded(u, v, xs, alpha, mask, transpose)
    _record_stream(u, transpose)
    if not _on_card(u, v, xs, mask):
        return ref.qn_apply_multi_ref(u, v, xs, alpha, mask, transpose)
    m, bsz = u.shape[0], u.shape[1]
    out = cuda_qn.qn_apply_multi(
        u.reshape(m, bsz, -1), v.reshape(m, bsz, -1),
        xs.reshape(kk, bsz, -1), alpha, mask, transpose)
    return out.reshape(xs.shape)


def qn_apply(u, v, x, alpha, mask) -> torch.Tensor:
    """``H @ x`` for one right-hand side ``x: (B, *F)`` over U/V
    ``(m, B, *F)``; returns ``(B, *F)`` in ``x.dtype``."""
    _record_stream(u, (False,))
    if not _on_card(u, v, x, mask):
        return ref.qn_apply_ref(u, v, x, alpha, mask)
    m, bsz = u.shape[0], u.shape[1]
    out = cuda_qn.qn_apply(u.reshape(m, bsz, -1), v.reshape(m, bsz, -1),
                           x.reshape(bsz, -1), alpha, mask)
    return out.reshape(x.shape)


def lowrank_append(u, v, s, hy, b, inv_den, slot, upd):
    """Write ``a = (s - hy) * inv_den`` and ``b`` into ring slot ``slot[b]``
    where ``upd``; returns ``(new_u, new_v, ev_u, ev_v)`` (see
    ``kernels/ref.lowrank_append_ref``).  On the card ``u``/``v`` are
    updated in place and returned as ``new_u``/``new_v``: callers treat the
    inputs as consumed."""
    if not _on_card(u, v, s, hy, b):
        return ref.lowrank_append_ref(u, v, s, hy, b, inv_den, slot, upd)
    m, bsz = u.shape[0], u.shape[1]
    feat = u.shape[2:]
    new_u, new_v, ev_u, ev_v = cuda_qn.lowrank_append(
        u.reshape(m, bsz, -1), v.reshape(m, bsz, -1), s.reshape(bsz, -1),
        hy.reshape(bsz, -1), b.reshape(bsz, -1), inv_den, slot, upd)
    return (new_u.reshape(u.shape), new_v.reshape(v.shape),
            ev_u.reshape((bsz,) + feat), ev_v.reshape((bsz,) + feat))


def broyden_step(u, v, g_new, s, hg_old, alpha, mask, slot, active, eps):
    """One Broyden iteration's memory work as one fused U/V pass (it counts
    as exactly one stream call; on the card it is two launches): ``H @
    g_new``, ``H^T @ s``, the denominator ``s^T H y`` and the guarded ring
    append.  Returns ``(new_u, new_v, hg_new, b, den, ev_u, ev_v)`` (see
    ``kernels/ref.broyden_step_ref``).  On the card ``u``/``v`` are updated
    in place and returned as ``new_u``/``new_v``: callers treat the inputs
    as consumed."""
    if _sharded(u, v, g_new, s, hg_old, mask, slot, active):
        return _broyden_step_sharded(u, v, g_new, s, hg_old, alpha, mask,
                                     slot, active, eps)
    _record_stream(u, (False, True))
    if not _on_card(u, v, g_new, s, hg_old, mask):
        return ref.broyden_step_ref(u, v, g_new, s, hg_old, alpha, mask,
                                    slot, active, eps)
    m, bsz = u.shape[0], u.shape[1]
    feat = u.shape[2:]
    new_u, new_v, hg_new, b, den, ev_u, ev_v = cuda_qn.broyden_step(
        u.reshape(m, bsz, -1), v.reshape(m, bsz, -1),
        g_new.reshape(bsz, -1), s.reshape(bsz, -1),
        hg_old.reshape(bsz, -1), alpha, mask, slot, active, eps)
    unflat = (lambda a: a.reshape((bsz,) + feat))
    return (new_u.reshape(u.shape), new_v.reshape(v.shape), unflat(hg_new),
            unflat(b), den, unflat(ev_u), unflat(ev_v))


# ---------------------------------------------------------------------------
# attention / rmsnorm
# ---------------------------------------------------------------------------


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _recompute_grads(fn, inputs, grad_out):
    """Gradients of ``fn(*inputs)`` with respect to every input, by
    re-evaluating the plain version under autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
    return torch.autograd.grad(out, leaves, grad_out)


class _Attention(torch.autograd.Function):
    """Forward: the attention kernel (plain version for CPU tensors);
    backward: recompute through ``ref.attention_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_length, causal, scale):
        ctx.save_for_backward(q, k, v, kv_length)
        ctx.causal, ctx.scale = causal, scale
        return _attention_fwd(q, k, v, kv_length, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_length = ctx.saved_tensors
        dq, dk, dv = _recompute_grads(
            lambda q_, k_, v_: ref.attention_ref(
                q_, k_, v_, causal=ctx.causal, kv_length=kv_length,
                scale=ctx.scale), (q, k, v), g)
        return dq, dk, dv, None, None, None


def _attention_fwd(q, k, v, kv_length, causal, scale):
    if not _on_card(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, kv_length=kv_length,
                                 scale=scale)
    return cuda_fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), kv_length, causal=causal,
                                   scale=scale)


IMPLS = ("auto", "ref", "flash_xla", "pallas", "pallas_interpret")
# at or above this many score cells (S * T) the CPU ``auto`` policy takes
# the chunked flash_xla path (the JAX package's _FLASH_XLA_CELLS)
FLASH_XLA_CELLS = 1 << 20


def attention_route(impl: str | None, q: torch.Tensor,
                    k: torch.Tensor) -> str:
    """The route ``attention`` takes: ``kernel``, ``plain`` or
    ``flash_xla`` (the ``impl`` policy of the module docstring)."""
    impl = impl or "auto"
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    card = _on_card(q, k)
    if impl == "auto":
        if card:
            return "kernel"
        return ("flash_xla" if q.shape[1] * k.shape[1] >= FLASH_XLA_CELLS
                else "plain")
    if impl == "pallas" and not card:
        raise ValueError("impl='pallas' is the Hopper kernel: it takes CUDA "
                         "tensors (pallas_interpret is the plain version "
                         "on the CPU)")
    if impl == "pallas_interpret" and card:
        raise ValueError("impl='pallas_interpret' is the CPU stand-in of "
                         "the kernel; on the card ask for 'pallas'")
    return {"ref": "plain", "flash_xla": "flash_xla", "pallas": "kernel",
            "pallas_interpret": "plain"}[impl]


def attention(q, k, v, *, causal: bool = True, kv_length=None,
              scale: float | None = None, impl: str | None = None,
              block_q: int = 512, block_kv: int = 1024,
              unroll: bool = False) -> torch.Tensor:
    """Differentiable multi-head attention (B,S,H,hd) x (B,T,KV,hd) ->
    (B,S,H,hd) by the route ``impl`` selects (``attention_route``);
    ``block_q``/``block_kv``/``unroll`` apply to the flash_xla path
    only."""
    if _sharded(q, k, v):
        return _attention_sharded(q, k, v, causal=causal,
                                  kv_length=kv_length, scale=scale,
                                  impl=impl, block_q=block_q,
                                  block_kv=block_kv, unroll=unroll)
    route = attention_route(impl, q, k)
    if route == "flash_xla":
        return flash_xla.flash_attention_xla(
            q, k, v, causal=causal, kv_length=kv_length, scale=scale,
            block_q=block_q, block_kv=block_kv, unroll=unroll)
    if route == "plain" and _on_card(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, kv_length=kv_length,
                                 scale=scale)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, kv_length, causal, scale)
    return _attention_fwd(q, k, v, kv_length, causal, scale)


def decode_attention(q, k, v, kv_length, *,
                     scale: float | None = None) -> torch.Tensor:
    """q ``(B, H, hd)`` over the KV cache ``(B, T, KV, hd)``."""
    if _sharded(q, k, v):
        return _decode_attention_sharded(q, k, v, kv_length, scale=scale)
    if not _on_card(q, k, v):
        return ref.decode_attention_ref(q, k, v, kv_length, scale=scale)
    return cuda_fa.decode_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), kv_length, scale=scale)


class _RMSNorm(torch.autograd.Function):
    """Forward: the rmsnorm kernel (plain version for CPU tensors);
    backward: recompute through ``ref.rmsnorm_ref``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _recompute_grads(
            lambda x_, w_: ref.rmsnorm_ref(x_, w_, ctx.eps), (x, w), g)
        return dx, dw, None


def _rmsnorm_fwd(x, w, eps):
    if not _on_card(x, w):
        return ref.rmsnorm_ref(x, w, eps)
    return cuda_rms.rmsnorm(x.contiguous(), w, eps)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    if _sharded(x, w):
        return _rmsnorm_sharded(x, w, eps)
    if _needs_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)


# ---------------------------------------------------------------------------
# sharded routes (DTensor inputs): every rank's local shard through the op
# ---------------------------------------------------------------------------


def _sharded(*ts) -> bool:
    return any(isinstance(t, DTensor) for t in ts)


def _mesh_of(*ts):
    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def _keep(pls, ok) -> tuple:
    """``pls`` with every placement ``ok`` rejects (and every ``Partial``)
    replaced by ``Replicate``."""
    return tuple(p if (isinstance(p, (Shard, Replicate)) and ok(p))
                 else Replicate() for p in pls)


def _batch_only(pls, dim: int) -> tuple:
    """Per mesh dim: ``Shard(dim)`` where ``pls`` splits the batch (dim 0),
    else replicated."""
    return tuple(Shard(dim) if isinstance(p, Shard) and p.dim == 0
                 else Replicate() for p in pls)


def _rmsnorm_sharded(x, w, eps):
    mesh = _mesh_of(x, w)
    x = as_dtensor(x, mesh)
    nd = x.ndim
    xp = _keep(x.placements, lambda p: isinstance(p, Replicate)
               or p.dim != nd - 1)
    rep = (Replicate(),) * mesh.ndim
    # the weight's gradient sums over the rows every rank holds
    wg = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in xp)
    fn = shard_map_compat(lambda a, b: rmsnorm(a, b, eps), mesh,
                          in_specs=(xp, rep), out_specs=xp,
                          in_grad_specs=(xp, wg))
    return fn(x, as_dtensor(w, mesh))


def _attention_sharded(q, k, v, *, causal, kv_length, scale, impl, block_q,
                       block_kv, unroll):
    """Batch and heads split, the sequences whole: each rank attends its
    query heads over their KV heads."""
    mesh = _mesh_of(q, k, v)
    q, k, v = as_dtensor(q, mesh), as_dtensor(k, mesh), as_dtensor(v, mesh)
    h, kvh = q.shape[2], k.shape[2]
    qp = _keep(q.placements, lambda p: isinstance(p, Replicate)
               or p.dim in (0, 2))
    kp, kg = [], []
    for i, p in enumerate(qp):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 2 and kvh % n:
            kp.append(Replicate())   # KV heads do not divide: whole
            kg.append(Partial())
        else:
            kp.append(p)
            kg.append(p)
    kp, kg = tuple(kp), tuple(kg)
    (_, _, h_loc, _), (_, _, h0, _) = local_shard(q.shape, mesh, qp)
    whole_kv = any(isinstance(p, Shard) and p.dim == 2 for p in qp) and \
        not any(isinstance(p, Shard) and p.dim == 2 for p in kp)
    lens = None if kv_length is None else as_dtensor(kv_length, mesh)
    lp = None if lens is None else _batch_only(qp, 0)

    def body(ql, kl, vl, ll):
        if whole_kv:  # this rank's query heads' KV groups
            g = h // kvh
            if h_loc % g == 0 and h0 % g == 0:
                kl = kl[:, :, h0 // g:(h0 + h_loc) // g]
                vl = vl[:, :, h0 // g:(h0 + h_loc) // g]
            else:
                kl = kl.repeat_interleave(g, dim=2)[:, :, h0:h0 + h_loc]
                vl = vl.repeat_interleave(g, dim=2)[:, :, h0:h0 + h_loc]
        return attention(ql, kl.contiguous(), vl.contiguous(), causal=causal,
                         kv_length=ll, scale=scale, impl=impl,
                         block_q=block_q, block_kv=block_kv, unroll=unroll)

    fn = shard_map_compat(body, mesh, in_specs=(qp, kp, kp, lp),
                          out_specs=qp, in_grad_specs=(qp, kg, kg, None))
    return fn(q, k, v, lens)


def _decode_attention_sharded(q, k, v, kv_length, *, scale):
    """q ``(B, H, hd)`` over a cache split over batch, KV heads or its
    length T (at most one mesh dim splits T)."""
    mesh = _mesh_of(q, k, v)
    q, k, v = as_dtensor(q, mesh), as_dtensor(k, mesh), as_dtensor(v, mesh)
    lens = as_dtensor(torch.as_tensor(kv_length, dtype=torch.int32)
               if not isinstance(kv_length, torch.Tensor) else kv_length,
               mesh)
    kp = _keep(k.placements, lambda p: isinstance(p, Replicate)
               or p.dim in (0, 1, 2))
    t_dims = [i for i, p in enumerate(kp) if isinstance(p, Shard)
              and p.dim == 1]
    if len(t_dims) > 1:
        raise ValueError("a decode cache splits its length over one mesh "
                         "dim")
    # the query: batch as the cache's, heads as the cache's KV heads
    qp = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
               Shard(1) if isinstance(p, Shard) and p.dim == 2 else
               Replicate() for p in kp)
    lp = _batch_only(kp, 0)
    if not t_dims:
        fn = shard_map_compat(lambda a, b, c, ln: decode_attention(
            a, b, c, ln, scale=scale), mesh, in_specs=(qp, kp, kp, lp),
            out_specs=qp)
        return fn(q, k, v, lens)
    td = t_dims[0]
    t0 = shard_offset(k.shape, mesh, kp)[1]
    group = mesh.get_group(td)

    def body(ql, kl, vl, ll):
        local_len = torch.clamp(ll.to(torch.int32) - t0, 0, kl.shape[1])
        part = decode_partials(ql, kl, vl, local_len, scale=scale)
        parts = [torch.empty_like(part) for _ in range(mesh.size(td))]
        dist.all_gather(parts, part.contiguous(), group=group)
        return decode_combine(torch.cat(parts, dim=2), ql.dtype)

    fn = shard_map_compat(body, mesh, in_specs=(qp, kp, kp, lp),
                          out_specs=qp)
    return fn(q, k, v, lens)


def decode_partials(q, k, v, kv_length, *, scale=None) -> torch.Tensor:
    """The split half of the decode: per row, head and key chunk, the
    partial ``(m, l, acc[hd])`` ``(B, H, n_chunks, hd + 2)`` in f32 (``acc``
    unnormalised, weights ``exp(s - m)``).  ``kv_length`` 0 is a slice with
    no valid key: ``l = 0`` (the combine skips it).  On the card the
    ``decode_split_kernel`` launch (bf16); on the CPU one chunk a row."""
    if _on_card(q, k, v):
        part = cuda_fa.decode_partials(q.contiguous(), k.contiguous(),
                                       v.contiguous(), kv_length, scale=scale)
        # the kernel reads kv_length 0 as the whole slice (the fused
        # decode's convention): a slice with no valid key must add nothing
        part[..., 1].masked_fill_((kv_length == 0)[:, None, None], 0.0)
        return part
    return ref.decode_partials_ref(q, k, v, kv_length, scale=scale)


def decode_combine(partials: torch.Tensor, dtype) -> torch.Tensor:
    """Merge ``(B, H, n, hd + 2)`` partials into ``(B, H, hd)`` (the
    ``decode_combine_kernel`` launch on the card)."""
    if _on_card(partials):
        return cuda_fa.decode_combine(partials.contiguous(), dtype)
    return ref.decode_combine_ref(partials).to(dtype)


def qn_apply_multi_sharded(u, v, xs, alpha, mask, transpose=None):
    """``qn_apply_multi`` on batch-split operands: every rank applies its
    rows' inverse to its rows, no collective (the reference's shard_map
    route).  ``u``/``v`` ``(m, B, *F)`` and ``xs`` ``(K, B, *F)`` split
    along B (axis 1), ``mask`` ``(m, B)`` likewise."""
    mesh = _mesh_of(u, v, xs, mask)
    u, v, xs, mask = (as_dtensor(t, mesh) for t in (u, v, xs, mask))
    bp = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 1
               else Replicate() for p in u.placements)
    rep = (Replicate(),) * mesh.ndim
    alpha = as_dtensor(torch.as_tensor(alpha, dtype=torch.float32), mesh) \
        if not isinstance(alpha, DTensor) else alpha
    fn = shard_map_compat(lambda a, b, c, al, mk: qn_apply_multi(
        a, b, c, al, mk, transpose), mesh, in_specs=(bp, bp, bp, rep, bp),
        out_specs=bp)
    return fn(u, v, xs, alpha.to(u.device), mask)


def _broyden_step_sharded(u, v, g_new, s, hg_old, alpha, mask, slot, active,
                          eps):
    mesh = _mesh_of(u, v, g_new, s, hg_old, mask, slot, active)
    bp1 = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 1
                else Replicate() for p in as_dtensor(u, mesh).placements)
    bp0 = tuple(Shard(0) if isinstance(p, Shard) else p for p in bp1)
    rep = (Replicate(),) * mesh.ndim
    alpha = alpha if isinstance(alpha, DTensor) else as_dtensor(
        torch.as_tensor(alpha, dtype=torch.float32, device=u.device), mesh)
    fn = shard_map_compat(
        lambda a, b, c, d, e, al, mk, sl, ac: broyden_step(
            a, b, c, d, e, al, mk, sl, ac, eps), mesh,
        in_specs=(bp1, bp1, bp0, bp0, bp0, rep, bp1, bp0, bp0),
        out_specs=[bp1, bp1, bp0, bp0, bp0, bp0, bp0])
    return fn(*(as_dtensor(t, mesh) for t in (u, v, g_new, s, hg_old)), alpha,
              *(as_dtensor(t, mesh) for t in (mask, slot, active)))
