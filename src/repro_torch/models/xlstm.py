"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, sequential recurrence), xLSTM-1.3B's 7:1 backbone.

The port of ``repro/models/xlstm.py``.  Training and prefill run the mLSTM
in its *chunkwise* form (stabilised log-space gates): within a chunk an
attention-like quadratic term, across chunks a linear recurrence over the
``(C, n, m)`` state, here a short Python loop over the chunks in place of
``lax.scan``.  A sequence that is not a chunk multiple is right-padded with
state-neutral gates (input pre-activation -1e30, forget +1e30), so the
final state is exact.  Decode (``seq == 1``) is one recurrent step
(``mlstm_step``, also the sequential oracle).  The sLSTM has no parallel
form: a Python loop over time.  Both cells run in f32 whatever the
activation dtype, as in the reference, and both stabilisers start at
-1e30.

Differences from the reference:

  * the reference's 3-operand einsums, whose order ``opt_einsum`` picks,
    are fixed pairwise contractions (the two ``(B, Q, Q, H)`` or gate
    factors first, then one batched matmul), so the order does not depend
    on whether the host has ``opt_einsum`` (exact in value up to f32
    rounding);
  * the sLSTM's input projection ``x @ w_in + bias`` runs as one GEMM over
    all ``B x S`` rows before the time loop, not one per step, and it and
    the recurrent weights are cast to f32 once: the same function up to
    the GEMM's rounding (``tests/test_torch_xlstm.py`` holds it at rtol
    1e-5 in f32).

Like ``mamba2_block``, neither block writes the cache it is given: each
returns a new one (the stack stores it), so a DEQ solve can evaluate a
block many times against the same frozen state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDecl
from repro_torch.parallel.sharding import NULL_CTX, ShardCtx

# the stabilisers' start, and the input gate of a pad step (state-neutral)
NEG = -1e30


class MLSTMCache(NamedTuple):
    C: torch.Tensor   # (B, H, dk, dv) matrix memory
    n: torch.Tensor   # (B, H, dk) normaliser
    m: torch.Tensor   # (B, H) stabiliser


class SLSTMCache(NamedTuple):
    c: torch.Tensor   # (B, H, hd)
    n: torch.Tensor   # (B, H, hd)
    h: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H, hd)


def _mlstm_dims(cfg: ModelConfig):
    inner = int(cfg.d_model * cfg.xlstm.mlstm_proj_factor)
    heads = cfg.num_heads
    return inner, heads, inner // heads


# the block-diagonal per-head projections
_HEAD_BLOCK = ("ssm_heads", None, None)


def mlstm_decl(cfg: ModelConfig) -> dict:
    """Per-head BLOCK-DIAGONAL q/k/v projections, as the xLSTM paper's
    BlockLinear (a dense ``(inner, inner)`` qkv would about double the
    published parameter count at this width)."""
    d = cfg.d_model
    inner, h, hd = _mlstm_dims(cfg)
    return {
        "w_up": ParamDecl((d, 2 * inner), ("embed", "ssm_inner")),
        "w_q": ParamDecl((h, hd, hd), _HEAD_BLOCK),
        "w_k": ParamDecl((h, hd, hd), _HEAD_BLOCK),
        "w_v": ParamDecl((h, hd, hd), _HEAD_BLOCK),
        "w_i": ParamDecl((inner, h), ("ssm_inner", None), "normal", 0.02),
        "w_f": ParamDecl((inner, h), ("ssm_inner", None), "normal", 0.02),
        "f_bias": ParamDecl((h,), (None,), "ones"),
        "w_down": ParamDecl((inner, d), ("ssm_inner", "embed")),
    }


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``, softplus as
    ``logaddexp(x, 0)``."""
    return -torch.logaddexp(-x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _mlstm_qkvif(params: dict, xm: torch.Tensor, h: int, hd: int):
    dt = xm.dtype
    xh = xm.reshape(xm.shape[:2] + (h, hd))                 # (B, S, H, hd)
    q, k, v = (torch.einsum("bshd,hde->bshe", xh, params[w].to(dt))
               for w in ("w_q", "w_k", "w_v"))
    i_pre = (xm @ params["w_i"].to(dt)).float()
    f_pre = (xm @ params["w_f"].to(dt)).float()
    f_pre = f_pre + params["f_bias"].float() + 3.0          # forget-biased
    return q, k, v, i_pre, f_pre


def mlstm_cell_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_pre: torch.Tensor, f_pre: torch.Tensor,
                       cache: MLSTMCache, chunk: int):
    """Chunkwise stabilised mLSTM over ``q, k, v (B, S, H, hd)`` and the
    gate pre-activations ``i_pre, f_pre (B, S, H)`` (f32), from ``cache``.
    Returns ``(y (B, S, H, hd) in q's dtype, new MLSTMCache)``."""
    b, seq, h, hd = q.shape
    qf = q.float() * (hd ** -0.5)
    kf, vf = k.float(), v.float()
    cq = min(chunk, seq)
    orig_seq = seq
    if seq % cq:
        # right-pad to a chunk multiple with state-neutral gates: forget
        # pre-activation +1e30 (log-sigmoid 0: no decay) and input -1e30
        # (no contribution), so the final (C, n, m) is exact
        pad = cq - seq % cq
        qf, kf, vf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (qf, kf, vf))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=NEG)
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=-NEG)
        seq = seq + pad
    nc = seq // cq

    def rs(x):  # (B, S, ...) -> (B, nc, cq, ...)
        return x.reshape((b, nc, cq) + x.shape[2:])

    qs, ks, vs, is_ = rs(qf), rs(kf), rs(vf), rs(i_pre)
    cumf = torch.cumsum(_log_sigmoid(rs(f_pre)), dim=2)     # inclusive
    tri = torch.ones((cq, cq), dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]
    C, n, m = cache
    ys = []
    for c in range(nc):
        qc, kc, vc = qs[:, c], ks[:, c], vs[:, c]           # (B, cq, H, hd)
        ic, bc = is_[:, c], cumf[:, c]                      # (B, cq, H)
        # intra decays D[i, j] = b_i - b_j + i_j (j <= i), masked before
        # the exponential
        Dm = bc[:, :, None, :] - bc[:, None, :, :] + ic[:, None, :, :]
        Dm = torch.where(tri, Dm, float("-inf"))            # (B, cq, cq, H)
        m_intra = Dm.amax(dim=2)                            # (B, cq, H)
        # inter decay for position i: g_i = b_i + m_prev
        g = bc + m[:, None, :]
        m_tot = torch.maximum(m_intra, g)                   # stabiliser
        s_qk = torch.einsum("bihd,bjhd->bijh", qc, kc)
        sw = s_qk * torch.exp(Dm - m_tot[:, :, None, :])
        num_intra = torch.einsum("bijh,bjhd->bihd", sw, vc)
        den_intra = sw.sum(dim=2)                           # (B, cq, H)
        w_inter = torch.exp(g - m_tot)
        num_inter = torch.einsum("bihd,bhde->bihe", qc, C) * w_inter[..., None]
        den_inter = torch.einsum("bihd,bhd->bih", qc, n) * w_inter
        den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_tot))
        ys.append((num_intra + num_inter) / den[..., None])
        # ---- the state at the chunk's end ----
        f_c = bc[:, -1, :]                                  # (B, H)
        dec_j = f_c[:, None, :] - bc + ic                   # (B, cq, H)
        m_new = torch.maximum(f_c + m, dec_j.amax(dim=1))
        sc_w = torch.exp(dec_j - m_new[:, None, :])
        carry = torch.exp(f_c + m - m_new)
        kw = sc_w[..., None] * kc                           # (B, cq, H, hd)
        C = carry[:, :, None, None] * C + torch.einsum("bjhd,bjhe->bhde",
                                                       kw, vc)
        n = carry[:, :, None] * n + kw.sum(dim=1)
        m = m_new
    y = torch.cat(ys, dim=1)[:, :orig_seq]
    return y.to(q.dtype), MLSTMCache(C, n, m)


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, cache: MLSTMCache):
    """One recurrent step (decode, and the sequential oracle): ``q, k, v
    (B, H, hd)``, ``i_pre, f_pre (B, H)``.  Returns ``(y (B, H, hd),
    new MLSTMCache)``."""
    hd = q.shape[-1]
    qf = q.float() * (hd ** -0.5)
    kf, vf = k.float(), v.float()
    logf = _log_sigmoid(f_pre)
    m_new = torch.maximum(logf + cache.m, i_pre)
    fw = torch.exp(logf + cache.m - m_new)
    iw = torch.exp(i_pre - m_new)
    C = (fw[..., None, None] * cache.C
         + iw[..., None, None] * (kf[..., :, None] * vf[..., None, :]))
    n = fw[..., None] * cache.n + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum((qf * n).sum(dim=-1).abs(), torch.exp(-m_new))
    y = num / den[..., None]
    return y.to(q.dtype), MLSTMCache(C, n, m_new)


def mlstm_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: MLSTMCache | None = None, ctx: ShardCtx = NULL_CTX):
    """One mLSTM mixer over ``x (B, S, d)`` (already normed).  Returns
    ``(out (B, S, d), new_cache)``: None without a cache, else a new
    ``MLSTMCache`` (the one passed in is left as it was)."""
    inner, h, hd = _mlstm_dims(cfg)
    dt = x.dtype
    up = ctx.constrain(x @ params["w_up"].to(dt),
                       ("batch", "seq", "ssm_inner"))
    xm, zg = up.split(inner, dim=-1)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(params, xm, h, hd)
    b, seq = x.shape[:2]
    if cache is None:
        y, _ = mlstm_cell_chunked(q, k, v, i_pre, f_pre,
                                  mlstm_cache_shape(cfg, b, x.device),
                                  cfg.xlstm.chunk)
        new_cache = None
    elif seq == 1:
        y, new_cache = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0],
                                  f_pre[:, 0], cache)
        y = y[:, None]
    else:  # prefill
        y, new_cache = mlstm_cell_chunked(q, k, v, i_pre, f_pre, cache,
                                          cfg.xlstm.chunk)
    y = y.reshape(b, seq, inner) * F.silu(zg)
    return ctx.constrain(y @ params["w_down"].to(dt),
                         ("batch", "seq_res", "embed_act")), new_cache


def mlstm_cache_shape(cfg: ModelConfig, batch: int,
                      device=None) -> MLSTMCache:
    """A cold cache for one layer: zero memory and normaliser, the
    stabiliser at -1e30."""
    inner, h, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return MLSTMCache(
        C=torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, h, hd), dtype=f32, device=device),
        m=torch.full((batch, h), NEG, dtype=f32, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_ff(cfg: ModelConfig) -> int:
    return int(round(cfg.d_model * cfg.xlstm.slstm_proj_factor / 64)) * 64


def slstm_decl(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    ffd = _slstm_ff(cfg)
    return {
        # z, i, f, o
        "w_in": ParamDecl((d, 4 * d), ("embed", "ssm_inner")),
        "r": ParamDecl((4, h, hd, hd), (None, "ssm_heads", None, None),
                       "normal", 0.02),
        "bias": ParamDecl((4 * d,), ("ssm_inner",), "zeros"),
        "ff_g": ParamDecl((d, ffd), ("embed", "mlp")),
        "ff_u": ParamDecl((d, ffd), ("embed", "mlp")),
        "ff_o": ParamDecl((ffd, d), ("mlp", "embed")),
    }


def _slstm_input(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The input projection ``x @ w_in + bias`` in the activation dtype,
    over every row of ``x (..., d)`` at once."""
    dt = x.dtype
    return x @ params["w_in"].to(dt) + params["bias"].to(dt)


def _slstm_recur(r: torch.Tensor, pre: torch.Tensor, cache: SLSTMCache,
                 cfg: ModelConfig):
    """The step's recurrence from its input projection ``pre (B, 4d)``
    (rounded to the activation dtype, then cast to f32) and the recurrent
    weights ``r (4, H, hd, hd)`` in f32: the pre-activations plus the
    block-diagonal recurrent term, then the exponentially gated update."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    b = pre.shape[0]
    pre = pre.reshape(b, 4, h, hd)
    # "bhd,ghde->bghe": per head, h_prev @ r[g, head]
    rec = torch.matmul(cache.h.transpose(0, 1)[None], r)
    pre = pre + rec.permute(2, 0, 1, 3)                     # (B, 4, H, hd)
    z_t = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_m = pre[:, 2] + cache.m
    o_t = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(f_m, i_t)
    fw = torch.exp(f_m - m_new)
    iw = torch.exp(i_t - m_new)
    c = fw * cache.c + iw * z_t
    n = fw * cache.n + iw
    hidden = o_t * c / torch.clamp(n, min=1e-6)
    return hidden, SLSTMCache(c, n, hidden, m_new)


def slstm_cell_step(params: dict, x_t: torch.Tensor, cache: SLSTMCache,
                    cfg: ModelConfig):
    """One sLSTM step with exp-gating stabilisation; ``x_t (B, d)``.
    Returns ``(hidden (B, H, hd) f32, new SLSTMCache)``."""
    return _slstm_recur(params["r"].float(),
                        _slstm_input(params, x_t).float(), cache, cfg)


def slstm_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: SLSTMCache | None = None, ctx: ShardCtx = NULL_CTX):
    """The sLSTM time loop over ``x (B, S, d)`` (already normed), then the
    gated feed-forward (pf 4/3, tanh GELU).  Returns ``(out (B, S, d),
    new_cache)``: None without a cache, else a new ``SLSTMCache``."""
    b, seq, d = x.shape
    ret_cache = cache is not None
    if cache is None:
        cache = slstm_cache_shape(cfg, b, x.device)
    # the input projection and both casts to f32 once, outside the loop
    pre = _slstm_input(params, x).float()                   # (B, S, 4d)
    r = params["r"].float()
    hs = []
    for t in range(seq):
        hidden, cache = _slstm_recur(r, pre[:, t], cache, cfg)
        hs.append(hidden)
    y = torch.stack(hs, dim=1).reshape(b, seq, d).to(x.dtype)
    dt = x.dtype
    g = y @ params["ff_g"].to(dt)
    u = y @ params["ff_u"].to(dt)
    out = (F.gelu(g, approximate="tanh") * u) @ params["ff_o"].to(dt)
    out = ctx.constrain(out, ("batch", "seq_res", "embed_act"))
    return out, (cache if ret_cache else None)


def slstm_cache_shape(cfg: ModelConfig, batch: int,
                      device=None) -> SLSTMCache:
    """A cold cache for one layer: zeros, the stabiliser at -1e30."""
    h = cfg.num_heads
    shape = (batch, h, cfg.d_model // h)
    f32 = torch.float32
    return SLSTMCache(*(torch.zeros(shape, dtype=f32, device=device)
                        for _ in range(3)),
                      m=torch.full(shape, NEG, dtype=f32, device=device))


# ---------------------------------------------------------------------------
# Sequential oracles (tests)
# ---------------------------------------------------------------------------


def mlstm_scan_ref(params: dict, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """``mlstm_block`` one position at a time from a cold cache (each step
    ``mlstm_step``); must match the chunked block on the same params."""
    cache = mlstm_cache_shape(cfg, x.shape[0], x.device)
    outs = []
    for t in range(x.shape[1]):
        y, cache = mlstm_block(params, x[:, t:t + 1], cfg, cache)
        outs.append(y)
    return torch.cat(outs, dim=1)


def slstm_scan_ref(params: dict, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """``slstm_block`` from a cold cache with its recurrence written out
    step by step apart from ``_slstm_recur``: each step projects its own
    input (the reference's per-step ``x_t @ w_in``) and adds the recurrent
    term as the reference's einsum, then the gated feed-forward."""
    b, seq, d = x.shape
    h = cfg.num_heads
    hd = d // h
    dt = x.dtype
    c, n, hid, m = slstm_cache_shape(cfg, b, x.device)
    r = params["r"].float()
    hs = []
    for t in range(seq):
        pre = (x[:, t] @ params["w_in"].to(dt) + params["bias"].to(dt))
        pre = pre.reshape(b, 4, h, hd).float()
        pre = pre + torch.einsum("bhd,ghde->bghe", hid, r)
        i_t, f_t = pre[:, 1], pre[:, 2]
        m_new = torch.maximum(f_t + m, i_t)
        fw, iw = torch.exp(f_t + m - m_new), torch.exp(i_t - m_new)
        c = fw * c + iw * torch.tanh(pre[:, 0])
        n = fw * n + iw
        hid = torch.sigmoid(pre[:, 3]) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(hid)
    y = torch.stack(hs, dim=1).reshape(b, seq, d).to(dt)
    g = y @ params["ff_g"].to(dt)
    u = y @ params["ff_u"].to(dt)
    return (F.gelu(g, approximate="tanh") * u) @ params["ff_o"].to(dt)
