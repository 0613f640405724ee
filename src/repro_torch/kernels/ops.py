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

from repro_torch.kernels import flash_attention as cuda_fa
from repro_torch.kernels import flash_xla
from repro_torch.kernels import qn_apply as cuda_qn
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as cuda_rms
from repro_torch.obs import metrics as obs_metrics


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
    if _needs_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)
