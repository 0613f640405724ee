"""Plain PyTorch versions of every kernel on the ported path.

The port of ``repro/kernels/ref.py``: the CPU execution path (``ops``
dispatches CPU tensors here), the correctness reference the Hopper kernels
are held against on the card, and the thing the CPU tests hold against the
JAX oracles.  Precision follows the JAX oracles op for op: low-precision
operands, f32 accumulation, and the same casts back to the storage dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _flat(a: torch.Tensor, lead: int) -> torch.Tensor:
    """Collapse every axis after the first ``lead`` into one feature axis."""
    return a.reshape(a.shape[:lead] + (-1,))


def qn_apply_ref(u, v, x, alpha, mask) -> torch.Tensor:
    """``(alpha*I + sum_i mask_i u_i v_i^T) @ x`` for one right-hand side
    ``x: (B, *F)``, f32 accumulation, out in ``x.dtype``."""
    xf = _flat(x.float(), 1)
    coeff = torch.einsum("mbd,bd->mb", _flat(v.float(), 2), xf) * mask.float()
    out = alpha * xf + torch.einsum("mb,mbd->bd", coeff, _flat(u.float(), 2))
    return out.reshape(x.shape).to(x.dtype)


def qn_apply_multi_ref(
    u: torch.Tensor,      # (m, B, *F)
    v: torch.Tensor,      # (m, B, *F)
    xs: torch.Tensor,     # (K, B, *F) stacked right-hand sides
    alpha,                # scalar (float or 0-d tensor)
    mask: torch.Tensor,   # (m, B)
    transpose: tuple[bool, ...] | None = None,
) -> torch.Tensor:
    """``out[k] = (H^T if transpose[k] else H) @ xs[k]`` with
    ``H = alpha*I + sum_i mask_i u_i v_i^T``, f32 accumulation, out in
    ``xs.dtype``."""
    kk = xs.shape[0]
    if transpose is None:
        transpose = (False,) * kk
    xf = _flat(xs.float(), 2)
    maskf = mask.float()
    uf, vf = _flat(u.float(), 2), _flat(v.float(), 2)
    out = torch.zeros_like(xf)
    for t in (False, True):
        idx = [k for k, tk in enumerate(transpose) if bool(tk) is t]
        if not idx:
            continue
        cb, ab = (vf, uf) if not t else (uf, vf)  # coefficient / apply
        grp = xf[idx]
        coeff = torch.einsum("mbd,kbd->kmb", cb, grp) * maskf[None]
        out[idx] = alpha * grp + torch.einsum("kmb,mbd->kbd", coeff, ab)
    return out.reshape(xs.shape).to(xs.dtype)


def lowrank_append_ref(u, v, s, hy, b, inv_den, slot, upd):
    """Ring-slot write of ``a = (s - hy) * inv_den`` and ``b`` where
    ``upd``; returns ``(new_u, new_v, ev_u, ev_v)`` (evicted = the slot's
    previous contents).  Functional: ``u``/``v`` are not modified."""
    m, bsz = u.shape[0], u.shape[1]
    feat = (1,) * (u.ndim - 2)
    ar = torch.arange(m, dtype=torch.int32, device=u.device)
    hot = (ar[:, None] == slot[None, :].int()) & (upd.float() > 0.5)[None, :]
    hotf = hot.reshape((m, bsz) + feat)
    a = (s.float() - hy.float()) * inv_den.float().reshape((bsz,) + feat)
    barange = torch.arange(bsz, device=u.device)
    sl = slot.long()
    ev_u, ev_v = u[sl, barange], v[sl, barange]
    new_u = torch.where(hotf, a.to(u.dtype)[None], u)
    new_v = torch.where(hotf, b.to(v.dtype)[None], v)
    return new_u, new_v, ev_u, ev_v


def broyden_step_ref(u, v, g_new, s, hg_old, alpha, mask, slot, active,
                     eps: float):
    """One Broyden iteration's memory work: ``hg_new = H g_new``,
    ``b = H^T s``, ``den = s^T (hg_new - hg_old)`` and the guarded ring
    append.  Returns ``(new_u, new_v, hg_new, b, den, ev_u, ev_v)``."""
    xs = torch.stack([g_new.float(), s.float()])
    out = qn_apply_multi_ref(u, v, xs, alpha, mask, (False, True))
    hg_new, b = out[0], out[1]
    hy = hg_new - hg_old.float()
    den = (s.float() * hy).reshape(hy.shape[0], -1).sum(-1)
    safe = den.abs() > eps
    upd = (active.float() > 0.5) & safe
    inv_den = torch.where(safe, 1.0 / torch.where(safe, den,
                                                  torch.ones_like(den)),
                          torch.zeros_like(den))
    new_u, new_v, ev_u, ev_v = lowrank_append_ref(
        u, v, s, hy, b, inv_den, slot, upd)
    return new_u, new_v, hg_new, b, den, ev_u, ev_v


def _gqa_expand(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, H, hd) by repeating KV head groups."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // kv, dim=2)


def attention_ref(q, k, v, *, causal: bool = True,
                  kv_length: torch.Tensor | None = None,
                  q_offset: int = 0, scale: float | None = None,
                  logits_soft_cap: float | None = None) -> torch.Tensor:
    """Masked multi-head attention with GQA broadcast and f32 softmax.

    q ``(B, S, H, hd)``, k/v ``(B, T, KV, hd)``; ``q_offset`` is the
    position of ``q[:, 0]`` on the key axis (causal row s sees keys
    ``0..s + q_offset``); ``logits_soft_cap`` caps the scaled scores at
    ``cap * tanh(x / cap)``.  Masked scores are the finite ``NEG_INF``,
    so a row whose every key is masked averages all keys uniformly
    instead of producing NaN."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    scale = (hd ** -0.5) if scale is None else scale
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = torch.ones((b, 1, s, t), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        kpos = torch.arange(t, device=q.device)[None, :]
        mask = mask & (kpos <= qpos)[None, None]
    if kv_length is not None:
        kpos = torch.arange(t, device=q.device)[None, None, None, :]
        mask = mask & (kpos < kv_length.reshape(b, 1, 1, 1))
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention_blocked_ref(q, k, v, *, causal: bool = True,
                          kv_length: torch.Tensor | None = None,
                          scale: float | None = None,
                          block: int = 2048) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block`` keys, all in
    f32 (the probabilities are not rounded to the value dtype): the flash
    recurrence without the S x T score tensor.  The keys are zero-padded
    to whole blocks and masked, as in the JAX package."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    scale = (hd ** -0.5) if scale is None else scale
    k = _gqa_expand(k, h).float()
    v = _gqa_expand(v, h).float()
    if kv_length is None:
        kv_length = torch.full((b,), t, dtype=torch.int32, device=q.device)
    nb = -(-t // block)
    pad = nb * block - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float() * scale
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
    for i in range(nb):
        kc = k[:, i * block:(i + 1) * block]
        vc = v[:, i * block:(i + 1) * block]
        sc = torch.einsum("bshd,bthd->bhst", qf, kc)
        kpos = i * block + torch.arange(block, device=q.device)
        valid = (kpos[None, :] < kv_length.reshape(b, 1))[:, None, None, :]
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])[None, None]
        sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def decode_attention_ref(q, k, v, kv_length, *, scale=None):
    """Single-token attention: q ``(B, H, hd)`` over the cache."""
    return attention_ref(q[:, None], k, v, causal=False, kv_length=kv_length,
                         scale=scale)[:, 0]


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Mean square in f32, normalization applied in the activation dtype
    (as ``repro.kernels.ref.rmsnorm_ref``; the Hopper kernel, like the
    Pallas kernel, stays in f32 throughout — the two agree at the bf16
    tolerance)."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * weight.to(x.dtype)
