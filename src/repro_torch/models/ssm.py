"""Mamba2 (SSD) blocks: Zamba2's backbone.

The port of ``repro/models/ssm.py``.  Training and prefill use the
*chunked* SSD algorithm: an intra-chunk quadratic term (attention-like
batched matmuls) plus a linear recurrence over the chunk states, here a
short Python loop over the ``nc`` chunks in place of ``lax.scan``.  A
sequence that is not a chunk multiple is right-padded with ``dt = 0``
steps, which leave the recurrent state untouched.  Decode (``seq == 1``)
is one recurrent step.  The SSD runs in f32 whatever the activation dtype,
as in the reference.

Differences from the reference, each exact in value:

  * ``softplus`` is ``logaddexp(x, 0)`` (``jax.nn.softplus``), not
    ``F.softplus``, which turns into the identity above 20;
  * the reference's 3- and 4-operand einsums, whose order ``opt_einsum``
    picks, are written as fixed pairwise contractions (the weights first,
    then one batched matmul), so the order does not depend on whether the
    host has ``opt_einsum``;
  * the intra-chunk decay masks before the exponential,
    ``exp(where(j <= i, cum_i - cum_j, -inf))``, where the reference masks
    after it: the values are the same, but at a chunk of 256 the masked-out
    ``exp(cum_i - cum_j)`` overflows to inf, and its gradient through the
    ``where`` is ``0 * inf = nan``.

``mamba2_block`` never writes the cache it is given: it returns a new
``MambaCache`` (the caller stores it), so a DEQ solve can evaluate a block
many times against the same frozen state.  ``mamba2_scan_ref`` is the
sequential oracle the tests use.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import ParamDecl, act_dtype
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ShardCtx,
    map_local,
    reshape_whole,
)


class MambaCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) f32
    conv: torch.Tensor    # (B, d_conv - 1, conv_dim) rolling window


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nheads, conv_dim


def mamba2_decl(cfg: ModelConfig) -> dict:
    s, d_in, nh, conv_dim = _dims(cfg)
    d, gn = cfg.d_model, s.n_groups * s.d_state
    return {
        "w_z": ParamDecl((d, d_in), ("embed", "ssm_inner")),
        "w_x": ParamDecl((d, d_in), ("embed", "ssm_inner")),
        "w_B": ParamDecl((d, gn), ("embed", None)),
        "w_C": ParamDecl((d, gn), ("embed", None)),
        "w_dt": ParamDecl((d, nh), ("embed", "ssm_heads")),
        "conv_x": ParamDecl((s.d_conv, d_in), ("conv", "ssm_inner"), "normal",
                            0.5),
        "conv_B": ParamDecl((s.d_conv, gn), ("conv", None), "normal", 0.5),
        "conv_C": ParamDecl((s.d_conv, gn), ("conv", None), "normal", 0.5),
        "A_log": ParamDecl((nh,), ("ssm_heads",), "zeros"),
        "D": ParamDecl((nh,), ("ssm_heads",), "ones"),
        "dt_bias": ParamDecl((nh,), ("ssm_heads",), "zeros"),
        "norm": ParamDecl((d_in,), ("ssm_inner",), "ones"),
        "w_out": ParamDecl((d_in, d), ("ssm_inner", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 window: torch.Tensor | None = None):
    """Depthwise causal conv over seq: ``u (B, S, C)``, ``w (K, C)``, the
    K shifted products summed in ``u``'s dtype in the order ``i = 0..K-1``.
    With ``window (B, K-1, C)`` the conv continues a stream (decode).
    Returns ``(silu(out), new_window)``."""
    k = w.shape[0]
    if window is None:
        window = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                             device=u.device)
    full = torch.cat([window.to(u.dtype), u], dim=1)
    s = u.shape[1]
    out = w[0] * full[:, 0:s]
    for i in range(1, k):
        out = out + w[i] * full[:, i:i + s]
    new_window = full[:, -(k - 1):] if k > 1 else window
    return F.silu(out), new_window


def _project(params: dict, x: torch.Tensor):
    dt_ = x.dtype
    return tuple(x @ params[k].to(dt_)
                 for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _segsum_decay(cum: torch.Tensor) -> torch.Tensor:
    """``exp(cum_i - cum_j)`` for ``j <= i``, 0 above the diagonal.
    ``cum (..., Q, H) -> (..., H, Q, Q)``; masked before the exponential
    (see the module's notes)."""
    q = cum.shape[-2]
    ct = cum.transpose(-1, -2)
    diff = ct[..., :, None] - ct[..., None, :]       # (..., H, Q, Q)
    mask = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(torch.where(mask, diff, float("-inf")))


def _ssd_chunks(xh, dt, A, Bsq, Csq, D, prev_state, chunk: int):
    """The chunked SSD over ``xh (B, S, H, P)``, ``dt (B, S, H)`` (f32),
    ``A, D (H,)``, ``Bsq, Csq (B, S, N)`` (f32) from ``prev_state (B, H, P,
    N)``: ``(y (B, S, H, P) in f32 with the skip term, the last state)``.
    Rows and heads are independent."""
    f32 = torch.float32
    b, seq, nh, p = xh.shape
    n = Bsq.shape[-1]
    q = min(chunk, seq)
    orig_seq = seq
    if seq % q:
        # right-pad to a chunk multiple with dt = 0 steps: decay
        # exp(0) = 1 and increment dt*B*x = 0 leave the recurrent state
        # untouched, so the final cache is exact; padded outputs are
        # sliced off
        pad = q - seq % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bsq = F.pad(Bsq, (0, 0, 0, pad))
        Csq = F.pad(Csq, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        seq = seq + pad
    nc = seq // q
    xc = xh.reshape(b, nc, q, nh, p).to(f32)
    dtc = dt.reshape(b, nc, q, nh)
    Bc = Bsq.reshape(b, nc, q, n)
    Cc = Csq.reshape(b, nc, q, n)
    a = dtc * A                                             # (B,nc,Q,H)
    cum = torch.cumsum(a, dim=2)

    # intra-chunk: Y[i] = sum_{j<=i} (C_i.B_j) exp(cum_i-cum_j) dt_j x_j
    cb = Cc @ Bc.transpose(-1, -2)                          # (B,nc,Q,Q)
    L = _segsum_decay(cum)                                  # (B,nc,H,Q,Q)
    w_ij = (cb[:, :, None] * L) * dtc.transpose(-1, -2)[:, :, :, None, :]
    y_intra = (w_ij @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk states: S_c = sum_j exp(cum_last-cum_j) dt_j B_j (x) x_j
    decay_last = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,Q,H)
    xw = (decay_last * dtc)[..., None] * xc                 # (B,nc,Q,H,P)
    sc = torch.einsum("bcjhp,bcjn->bchpn", xw, Bc)

    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    h_prevs = []
    h = prev_state
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + sc[:, c]
    last_state = h
    h_prevs = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, seq, nh, p)
    y = y + D[None, None, :, None] * xh.to(f32)
    return y[:, :orig_seq], last_state


def mamba2_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 cache: MambaCache | None = None, ctx: ShardCtx = NULL_CTX):
    """One Mamba2 mixer over ``x (B, S, d)``.  Returns ``(out (B, S, d),
    new_cache)``; ``new_cache`` is None without a cache, else a new
    ``MambaCache`` (the one passed in is left as it was)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b, seq, _ = x.shape
    p, n = s.head_dim, s.d_state
    dt_ = x.dtype
    f32 = torch.float32

    z, xin, Bs, Cs, dt_raw = _project(params, x)
    xin = ctx.constrain(xin, ("batch", "seq", "ssm_inner"))
    win = cache.conv if cache is not None else None
    u = torch.cat([xin, Bs, Cs], dim=-1)
    w_conv = torch.cat([params["conv_x"], params["conv_B"],
                        params["conv_C"]], dim=-1).to(dt_)
    u, new_win = _causal_conv(u, w_conv, win)
    gn = s.n_groups * s.d_state
    xin, Bs, Cs = torch.split(u, [d_in, gn, gn], dim=-1)

    dt = _softplus(dt_raw.to(f32) + params["dt_bias"])          # (B, S, H)
    A = -torch.exp(params["A_log"].to(f32))                     # (H,)
    xh = xin.reshape(b, seq, nh, p)
    if s.n_groups != 1:
        raise NotImplementedError("n_groups > 1")
    Bsq = Bs.to(f32)                                            # (B, S, N)
    Csq = Cs.to(f32)
    D = params["D"].to(f32)

    prev_state = cache.state if cache is not None else torch.zeros(
        (b, nh, p, n), dtype=f32, device=x.device)

    if seq == 1:
        # ---- decode: one recurrent step ----
        da = torch.exp(dt[:, 0] * A[None, :])                   # (B, H)
        x0 = xh[:, 0].to(f32)                                   # (B, H, P)
        inc = (dt[:, 0, :, None] * x0)[..., None] * Bsq[:, 0, None, None, :]
        state = da[..., None, None] * prev_state + inc
        if isinstance(state, DTensor):
            # a product and a sum: the batched matmul flattens the batch
            # and head dims, which some PyTorch versions' DTensor cannot
            # do with both split
            y = (state * Csq[:, 0, None, None, :]).sum(-1)
        else:
            y = (state @ Csq[:, 0, None, :, None])[..., 0]      # (B, H, P)
        y = y + D[None, :, None] * x0
        y = y.reshape(b, 1, d_in).to(dt_)
        new_cache = MambaCache(state, new_win)
    else:
        # ---- chunked SSD ----
        args = (xh, dt, A, Bsq, Csq, D, prev_state)

        def core(*a):
            return _ssd_chunks(*a, s.chunk)

        if ctx.running:
            heads = ("batch", None, "ssm_heads_act")
            y, last_state = map_local(
                core, ctx, args,
                (heads + (None,), heads, ("ssm_heads_act",),
                 ("batch", None, None), ("batch", None, None),
                 ("ssm_heads_act",), ("batch", "ssm_heads_act", None, None)),
                out_like=(0, 6))
        else:
            y, last_state = core(*args)
        y = reshape_whole(y, (b, seq, d_in), 2, nh).to(dt_)
        new_cache = MambaCache(last_state, new_win) \
            if cache is not None else None

    y = ctx.constrain(y, ("batch", "seq", "ssm_inner"))
    y = kernel_ops.rmsnorm((y * F.silu(z)).contiguous(),
                           params["norm"].to(dt_), cfg.norm_eps)
    return ctx.constrain(y @ params["w_out"].to(dt_),
                         ("batch", "seq_res", "embed_act")), new_cache


def mamba2_cache_shape(cfg: ModelConfig, batch: int,
                       device=None) -> MambaCache:
    """A zero cache for one layer: f32 state, the window in the config's
    dtype."""
    s, d_in, nh, conv_dim = _dims(cfg)
    return MambaCache(
        state=torch.zeros((batch, nh, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim),
                         dtype=act_dtype(cfg), device=device))


# ---------------------------------------------------------------------------
# Sequential oracle (tests)
# ---------------------------------------------------------------------------


def mamba2_scan_ref(params: dict, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Step-by-step recurrence; must match ``mamba2_block`` on the same
    params."""
    b, seq, _ = x.shape
    cache = mamba2_cache_shape(cfg, b, x.device)
    cache = MambaCache(cache.state, cache.conv.to(x.dtype))
    outs = []
    for t in range(seq):
        y, cache = mamba2_block(params, x[:, t:t + 1], cfg, cache)
        outs.append(y)
    return torch.cat(outs, dim=1)
