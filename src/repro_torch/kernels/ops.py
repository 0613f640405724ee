"""Public kernel ops: dispatch by the device of the tensors.

    tensor device | executes
    --------------+-------------------------------------------------------
    cpu           | the plain PyTorch version (kernels/ref.py)
    cuda          | the hand-written Hopper kernel (csrc/), or it raises

There is no other route and no fallback: a CUDA tensor never reaches a
plain version, and a failed build or launch raises.  (The JAX package's
``flash_xla`` route and its TPU sublane pad of the ring memory axis have no
counterpart here: the CUDA kernels mask the ragged edges themselves.)

Ops: ``qn_apply_multi`` (K stacked RHS, per-RHS H vs H^T, one U/V stream),
``broyden_step`` (one Broyden iteration's apply, denominator and guarded
ring append), ``attention``, ``decode_attention``, ``rmsnorm``.

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
from repro_torch.kernels import qn_apply as cuda_qn
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as triton_rms
from repro_torch.obs import metrics as obs_metrics


def _on_card(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else raises."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel ops take all-CPU or all-CUDA tensors; got "
                     f"{sorted(kinds)}")


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


def attention(q, k, v, *, causal: bool = True, kv_length=None,
              scale: float | None = None) -> torch.Tensor:
    """Multi-head attention (B,S,H,hd) x (B,T,KV,hd) -> (B,S,H,hd), forward
    only (the serving path needs no gradient)."""
    if not _on_card(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, kv_length=kv_length,
                                 scale=scale)
    return cuda_fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), kv_length, causal=causal,
                                   scale=scale)


def decode_attention(q, k, v, kv_length, *,
                     scale: float | None = None) -> torch.Tensor:
    """q ``(B, H, hd)`` over the KV cache ``(B, T, KV, hd)``."""
    if not _on_card(q, k, v):
        return ref.decode_attention_ref(q, k, v, kv_length, scale=scale)
    return cuda_fa.decode_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), kv_length, scale=scale)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    if not _on_card(x, w):
        return ref.rmsnorm_ref(x, w, eps)
    return triton_rms.rmsnorm(x.contiguous(), w, eps)
