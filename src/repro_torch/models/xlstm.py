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

Where a gradient is wanted both loops run as ``autograd.Function``s that
keep what the reference's scans keep: the mLSTM each chunk's entry state,
the sLSTM each step's, each chunk or step recomputed in the backward
(``_MLSTMChunks``, ``_SLSTMSteps``; eager autograd over the loops,
``mlstm_cell_chunked_ref`` and ``slstm_steps_ref``, kept every chunk's
and step's intermediates).  On a mesh whose "model" does not divide the
mLSTM heads (xLSTM-1.3B's 4 over 16) the heads are padded and split as
GSPMD splits them, ``ceil(H / tp)`` a rank (``_cell_padded_heads``); the
sLSTM loop runs on each rank's rows after one gather of its input.

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
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ShardCtx,
    even_placements,
    map_local,
    redistribute,
    reshape_whole,
)

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


def _mlstm_up(params: dict, x: torch.Tensor, inner: int, ctx: ShardCtx):
    """``x @ w_up`` as the cell's input ``xm`` and the output gate ``zg``,
    each ``(B, S, inner)`` on "ssm_inner".  Where a running mesh splits
    "ssm_inner", each is its own product with its half of ``w_up``: a split
    of one product's sharded last dim would gather it whole."""
    w = params["w_up"].to(x.dtype)
    axes = ("batch", "seq", "ssm_inner")
    if not ctx.running or ctx.axis_size("ssm_inner") == 1:
        return ctx.constrain(x @ w, axes).split(inner, dim=-1)
    return tuple(
        ctx.constrain(x @ ctx.constrain(half, ("embed", "ssm_inner")), axes)
        for half in w.split(inner, dim=-1))


def _mlstm_gates(params: dict, xm: torch.Tensor):
    """The input and forget gates' pre-activations ``(B, S, H)``, f32."""
    dt = xm.dtype
    i_pre = (xm @ params["w_i"].to(dt)).float()
    f_pre = (xm @ params["w_f"].to(dt)).float()
    return i_pre, f_pre + params["f_bias"].float() + 3.0   # forget-biased


def _mlstm_qkvif(params: dict, xm: torch.Tensor, h: int, hd: int):
    dt = xm.dtype
    xh = reshape_whole(xm, xm.shape[:2] + (h, hd), 2, h)   # (B, S, H, hd)
    q, k, v = (torch.einsum("bshd,hde->bshe", xh, params[w].to(dt))
               for w in ("w_q", "w_k", "w_v"))
    return (q, k, v) + _mlstm_gates(params, xm)


def _tril(cq: int, device) -> torch.Tensor:
    return torch.ones((cq, cq), dtype=torch.bool,
                      device=device).tril()[None, :, :, None]


def _chunk_inputs(q, k, v, i_pre, f_pre, c: int, cq: int) -> list:
    """Chunk ``c`` (``cq`` steps) of the cell's inputs.  The sequence's
    tail is right-padded with state-neutral steps: zero q/k/v, input
    pre-activation -1e30 (no contribution) and forget +1e30 (log-sigmoid
    0: no decay), so the final ``(C, n, m)`` is exact."""
    start = c * cq
    n = min(cq, q.shape[1] - start)
    parts = [t.narrow(1, start, n) for t in (q, k, v, i_pre, f_pre)]
    if n == cq:
        return parts
    pad = cq - n
    return ([F.pad(t, (0, 0, 0, 0, 0, pad)) for t in parts[:3]]
            + [F.pad(parts[3], (0, 0, 0, pad), value=NEG),
               F.pad(parts[4], (0, 0, 0, pad), value=-NEG)])


def _chunk_step(qc, kc, vc, ic, fc, C, n, m, tri):
    """One chunk of the stabilised mLSTM from the state ``(C, n, m)`` at
    its entry: ``qc, kc, vc (B, cq, H, hd)`` in their own dtype, the gate
    pre-activations ``ic, fc (B, cq, H)`` f32.  Returns ``(y (B, cq, H, hd)
    f32, C, n, m)`` with the state at the chunk's end."""
    qc = qc.float() * (qc.shape[-1] ** -0.5)
    kc, vc = kc.float(), vc.float()
    bc = torch.cumsum(_log_sigmoid(fc), dim=1)              # inclusive
    # intra decays D[i, j] = b_i - b_j + i_j (j <= i), masked before the
    # exponential
    Dm = bc[:, :, None, :] - bc[:, None, :, :] + ic[:, None, :, :]
    Dm = torch.where(tri, Dm, float("-inf"))                # (B, cq, cq, H)
    m_intra = Dm.amax(dim=2)                                # (B, cq, H)
    # inter decay for position i: g_i = b_i + m_prev
    g = bc + m[:, None, :]
    m_tot = torch.maximum(m_intra, g)                       # stabiliser
    s_qk = torch.einsum("bihd,bjhd->bijh", qc, kc)
    sw = s_qk * torch.exp(Dm - m_tot[:, :, None, :])
    num_intra = torch.einsum("bijh,bjhd->bihd", sw, vc)
    den_intra = sw.sum(dim=2)                               # (B, cq, H)
    w_inter = torch.exp(g - m_tot)
    num_inter = torch.einsum("bihd,bhde->bihe", qc, C) * w_inter[..., None]
    den_inter = torch.einsum("bihd,bhd->bih", qc, n) * w_inter
    den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_tot))
    y = (num_intra + num_inter) / den[..., None]
    # ---- the state at the chunk's end ----
    f_c = bc[:, -1, :]                                      # (B, H)
    dec_j = f_c[:, None, :] - bc + ic                       # (B, cq, H)
    m_new = torch.maximum(f_c + m, dec_j.amax(dim=1))
    sc_w = torch.exp(dec_j - m_new[:, None, :])
    carry = torch.exp(f_c + m - m_new)
    kw = sc_w[..., None] * kc                               # (B, cq, H, hd)
    C = carry[:, :, None, None] * C + torch.einsum("bjhd,bjhe->bhde", kw, vc)
    n = carry[:, :, None] * n + kw.sum(dim=1)
    return y, C, n, m_new


def mlstm_cell_chunked_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, i_pre: torch.Tensor,
                           f_pre: torch.Tensor, cache: MLSTMCache,
                           chunk: int, entries: list | None = None):
    """``mlstm_cell_chunked`` as a plain loop over the chunks, whose
    autograd keeps every chunk's intermediates: the plain version the
    chunk Function is held against, and that Function's forward, which
    passes ``entries`` (a list) to collect each chunk's entry state."""
    b, seq, h, hd = q.shape
    cq = min(chunk, seq)
    tri = _tril(cq, q.device)
    y = q.new_empty((b, seq, h, hd))
    state = tuple(cache)
    for c in range(-(-seq // cq)):
        if entries is not None:
            entries += state
        yc, *state = _chunk_step(
            *_chunk_inputs(q, k, v, i_pre, f_pre, c, cq), *state, tri)
        ln = min(cq, seq - c * cq)
        y.narrow(1, c * cq, ln).copy_(yc.narrow(1, 0, ln))
    return y, MLSTMCache(*state)


class _MLSTMChunks(torch.autograd.Function):
    """The chunk loop keeping what the reference's ``lax.scan`` keeps: the
    forward (the plain loop) saves the inputs in their own dtype and each
    chunk's entry state ``(C, n, m)``; the backward walks the chunks in
    reverse, recomputes each one's body (``_chunk_step``, the forward's)
    from its entry state and takes its VJP for the chunk's output gradient
    and the carried state gradient, writing each input's gradient into its
    slice."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C, n, m, chunk):
        entries = []
        y, state = mlstm_cell_chunked_ref(q, k, v, i_pre, f_pre,
                                          MLSTMCache(C, n, m), chunk, entries)
        ctx.cq = min(chunk, q.shape[1])
        ctx.save_for_backward(q, k, v, i_pre, f_pre, *entries)
        return (y, *state)

    @staticmethod
    def backward(ctx, gy, gC, gn, gm):
        q, k, v, i_pre, f_pre, *entries = ctx.saved_tensors
        cq, seq = ctx.cq, q.shape[1]
        tri = _tril(cq, q.device)
        ins = (q, k, v, i_pre, f_pre)
        grads = [torch.empty_like(t) for t in ins]
        carried = (gC, gn, gm)
        for c in reversed(range(len(entries) // 3)):
            start, ln = c * cq, min(cq, seq - c * cq)
            with torch.enable_grad():
                xs = [t.detach().requires_grad_(True) for t in
                      _chunk_inputs(*ins, c, cq)
                      + list(entries[3 * c:3 * c + 3])]
                yc, *state = _chunk_step(*xs, tri)
            gyc = F.pad(gy.narrow(1, start, ln).float(),
                        (0, 0, 0, 0, 0, cq - ln))
            got = torch.autograd.grad((yc, *state), xs, (gyc, *carried))
            for g, t in zip(grads, got[:5]):
                g.narrow(1, start, ln).copy_(t.narrow(1, 0, ln))
            carried = got[5:]
        return (*grads, *carried, None)


def mlstm_cell_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_pre: torch.Tensor, f_pre: torch.Tensor,
                       cache: MLSTMCache, chunk: int):
    """Chunkwise stabilised mLSTM over ``q, k, v (B, S, H, hd)`` and the
    gate pre-activations ``i_pre, f_pre (B, S, H)`` (f32), from ``cache``.
    Returns ``(y (B, S, H, hd) in q's dtype, new MLSTMCache)``.  Where a
    gradient is wanted it runs as ``_MLSTMChunks`` (the chunk entry states
    saved, each chunk recomputed in the backward), else as the plain
    loop, which then keeps nothing."""
    args = (q, k, v, i_pre, f_pre, *cache)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, *state = _MLSTMChunks.apply(*args, chunk)
        return y, MLSTMCache(*state)
    return mlstm_cell_chunked_ref(q, k, v, i_pre, f_pre, cache, chunk)


def _cold_mlstm(batch: int, h: int, hd: int, device=None) -> MLSTMCache:
    """A cold state: zero memory and normaliser, the stabiliser at
    -1e30."""
    f32 = torch.float32
    return MLSTMCache(
        C=torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, h, hd), dtype=f32, device=device),
        m=torch.full((batch, h), NEG, dtype=f32, device=device))


def _map_cell(fn, ctx: ShardCtx, args: tuple, in_axes: tuple, y_like: int,
              cache, cache_axes: tuple, cold, summed: str | None = None):
    """``fn(*args, state) -> (y, new state)`` from ``cache``, or from
    ``cold(*args)`` where it is None (and then only ``y`` comes back, with a
    None state).  On a running mesh it runs over each rank's local shards
    (``map_local``: ``args`` laid out by ``in_axes``, the state by
    ``cache_axes``; ``y`` comes back laid out as ``args[y_like]``, the state
    as it went in), so a cold state is made at the local shape."""
    state = () if cache is None else tuple(cache)
    k = len(args)

    def run(*xs):
        y, c = fn(*xs[:k], type(cache)(*xs[k:]) if state else cold(*xs[:k]))
        return (y, *c) if state else y

    if not ctx.running:
        out = run(*args, *state)
    else:
        out = map_local(run, ctx, args + state,
                        in_axes + (cache_axes if state else ()),
                        out_like=(y_like, *range(k, k + len(state))),
                        summed=summed)
    if not state:
        return out, None
    return out[0], type(cache)(*out[1:])


def _cell_chunked(q, k, v, i_pre, f_pre, cache: MLSTMCache | None,
                  chunk: int, ctx: ShardCtx):
    """``mlstm_cell_chunked`` from ``cache``, or from a cold state where it
    is None (and then only ``y`` is returned, with a ``None`` state).  On a
    running mesh over each rank's local rows and heads (the cell is
    independent across them)."""
    heads = ("batch", None, "ssm_heads_act")
    rows = ("batch", "ssm_heads_act")
    return _map_cell(
        lambda q, k, v, i_pre, f_pre, c0: mlstm_cell_chunked(
            q, k, v, i_pre, f_pre, c0, chunk),
        ctx, (q, k, v, i_pre, f_pre), (heads + (None,),) * 3 + (heads,) * 2,
        0, cache, (rows + (None, None), rows + (None,), rows),
        lambda q, *_: _cold_mlstm(q.shape[0], q.shape[2], q.shape[3],
                                  q.device))


def _heads(x: torch.Tensor, dim: int, lo: int, count: int) -> torch.Tensor:
    """Heads ``[lo, lo + count)`` of ``x`` along ``dim`` as a new tensor,
    zero past the last one ``x`` has."""
    n = max(0, min(count, x.shape[dim] - lo))
    part = x.narrow(dim, min(lo, x.shape[dim]), n)
    if n == count:
        return part.clone()
    shape = list(x.shape)
    shape[dim] = count - n
    return torch.cat([part, x.new_zeros(shape)], dim=dim)


def _unheads(x: torch.Tensor, dim: int, lo: int, h: int) -> torch.Tensor:
    """``x``'s heads (the ones from ``lo`` on, below ``h``) placed at
    ``[lo, ...)`` of ``h`` heads along ``dim``, zero elsewhere.  A rank
    that holds only pad heads pads an empty slice of ``x``, so its
    backward still reaches ``x`` (and issues the collectives of the other
    ranks' backward)."""
    lo = min(lo, h)
    n = min(x.shape[dim], h - lo)
    pad = [0, 0] * (x.dim() - 1 - dim) + [lo, h - lo - n]
    return F.pad(x.narrow(dim, 0, n), pad)


def _cell_padded_heads(params: dict, xm, cache: MLSTMCache | None,
                       cfg: ModelConfig, ctx: ShardCtx):
    """The chunked cell on a running mesh whose head mesh dims (those of
    "ssm_heads_act") do not divide the heads, split as GSPMD splits them:
    the heads padded to ``tp x ceil(H / tp)``, ``ceil(H / tp)`` a rank.
    Each rank views its heads out of ``xm`` gathered whole over those dims
    (pad heads get zero q/k/v, zero gate pre-activations and a zero
    entry state, ``m = 0`` too, so their state stays zero, their ``y`` 0
    and every value finite), projects them, runs the cell on them, and
    places its output at its heads of the whole: the sum over those mesh
    dims is the cell's output, reduce-scattered onto "ssm_inner".
    Returns ``(y (B, S, inner) on "ssm_inner", state)``: the state whole
    over heads where ``cache`` is given, else None."""
    inner, h, hd = _mlstm_dims(cfg)
    b, seq = xm.shape[:2]
    dt = xm.dtype
    hl = -(-h // ctx.axis_size("ssm_heads_act"))
    lo = ctx.entry_rank("ssm_heads_act") * hl

    def cell(xm, w_q, w_k, w_v, i_pre, f_pre, c0):
        xs = _heads(xm.reshape(xm.shape[:2] + (h, hd)), 2, lo, hl)
        w = torch.cat([_heads(t, 0, lo, hl) for t in (w_q, w_k, w_v)], -1)
        q, k, v = torch.einsum("bshd,hde->bshe", xs, w.to(dt)).split(hd, -1)
        y, c = mlstm_cell_chunked(
            q, k, v, _heads(i_pre, 2, lo, hl), _heads(f_pre, 2, lo, hl),
            MLSTMCache(*(_heads(t, 1, lo, hl) for t in c0)), cfg.xlstm.chunk)
        # the state is placed back only where it is returned
        return (_unheads(y, 2, lo, h),
                (_unheads(t, 1, lo, h) for t in c) if cache is not None
                else None)

    whole = ("batch", None, None)
    state_axes = (whole + (None,), whole, ("batch", None))
    y, c = _map_cell(
        cell, ctx, (xm, params["w_q"], params["w_k"], params["w_v"])
        + _mlstm_gates(params, xm), (whole,) + ((None, None, None),) * 3
        + (whole,) * 2, 4, cache, state_axes,
        lambda xm, *_: _cold_mlstm(xm.shape[0], h, hd, xm.device),
        summed="ssm_heads_act")
    y = ctx.constrain(y.reshape(b, seq, inner), ("batch", "seq", "ssm_inner"))
    if c is None:
        return y, None
    return y, MLSTMCache(*(
        redistribute(t, ctx.device_mesh, even_placements(ctx, ax, t.shape))
        for t, ax in zip(c, state_axes)))


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
    xm, zg = _mlstm_up(params, x, inner, ctx)
    b, seq = x.shape[:2]
    step = seq == 1 and cache is not None
    if not step and ctx.running and h % ctx.axis_size("ssm_heads_act"):
        y, new_cache = _cell_padded_heads(params, xm, cache, cfg, ctx)
    else:
        q, k, v, i_pre, f_pre = _mlstm_qkvif(params, xm, h, hd)
        if step:
            y, new_cache = mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                                      i_pre[:, 0], f_pre[:, 0], cache)
            y = y[:, None]
        else:  # a whole sequence (training), or a prefill into the cache
            y, new_cache = _cell_chunked(q, k, v, i_pre, f_pre, cache,
                                         cfg.xlstm.chunk, ctx)
        y = reshape_whole(y, (b, seq, inner), 2, h)
    y = y * F.silu(zg)
    return ctx.constrain(y @ params["w_down"].to(dt),
                         ("batch", "seq_res", "embed_act")), new_cache


def mlstm_cache_shape(cfg: ModelConfig, batch: int,
                      device=None) -> MLSTMCache:
    """A cold cache for one layer: zero memory and normaliser, the
    stabiliser at -1e30."""
    _, h, hd = _mlstm_dims(cfg)
    return _cold_mlstm(batch, h, hd, device)


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
    pre = reshape_whole(pre, (b, 4, h, hd), 1, 4)
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


def slstm_steps_ref(r: torch.Tensor, pre: torch.Tensor, cache: SLSTMCache,
                    cfg: ModelConfig, entries: list | None = None):
    """The sLSTM time loop as plain autograd code, which keeps every
    step's intermediates: ``r (4, H, hd, hd)`` f32, ``pre (B, S, 4d)`` in
    the activation dtype (each step cast to f32).  Returns ``(hidden (B,
    S, H, hd) f32, the last SLSTMCache)``; the plain version of
    ``_SLSTMSteps``, and its forward, which passes ``entries`` (a list) to
    collect each step's entry ``(c, n, m)``."""
    b, seq = pre.shape[:2]
    y = cache.c.new_empty((b, seq) + tuple(cache.c.shape[1:]))
    for t in range(seq):
        if entries is not None:
            entries += (cache.c, cache.n, cache.m)
        y[:, t], cache = _slstm_recur(r, pre[:, t].float(), cache, cfg)
    return y, cache


class _SLSTMSteps(torch.autograd.Function):
    """The sLSTM time loop keeping each step's state: the forward (the
    plain loop) saves ``pre`` in its own dtype, every step's ``(c, n, m)``
    and the hidden outputs (the steps' ``h``); the backward walks the
    steps in reverse, recomputes each one (``_slstm_recur``, the
    forward's) from its entry state and takes its VJP for the step's
    output gradient and the carried state gradient."""

    @staticmethod
    def forward(ctx, r, pre, c, n, h, m, cfg):
        saved = []
        y, state = slstm_steps_ref(r, pre, SLSTMCache(c, n, h, m), cfg,
                                   saved)
        ctx.cfg = cfg
        ctx.save_for_backward(r, pre, h, y, *saved)
        return (y, *state)

    @staticmethod
    def backward(ctx, gy, gc, gn, gh, gm):
        r, pre, h0, y, *saved = ctx.saved_tensors
        dpre = torch.empty_like(pre)
        dr = torch.zeros_like(r)
        dc, dn, dh, dm = gc, gn, gh, gm
        for t in reversed(range(pre.shape[1])):
            c, n, m = saved[3 * t:3 * t + 3]
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(True) for x in (
                    pre[:, t].float(), c, n, h0 if t == 0 else y[:, t - 1],
                    m, r)]
                hidden, st = _slstm_recur(xs[5], xs[0],
                                          SLSTMCache(*xs[1:5]), ctx.cfg)
            got = torch.autograd.grad(
                (hidden, st.c, st.n, st.m), xs, (gy[:, t] + dh, dc, dn, dm))
            dpre[:, t] = got[0]
            dr += got[5]
            dc, dn, dh, dm = got[1:5]
        return dr, dpre, dc, dn, dh, dm, None


def slstm_steps(r: torch.Tensor, pre: torch.Tensor, cache: SLSTMCache,
                cfg: ModelConfig):
    """The sLSTM time loop (``slstm_steps_ref``'s arguments and values);
    where a gradient is wanted it runs as ``_SLSTMSteps`` (each step's
    state saved, each step recomputed in the backward), else as the plain
    loop, which then keeps nothing."""
    args = (r, pre, *cache)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, *state = _SLSTMSteps.apply(*args, cfg)
        return y, SLSTMCache(*state)
    return slstm_steps_ref(r, pre, cache, cfg)


def _slstm_time(r, pre, cache: SLSTMCache | None, cfg: ModelConfig,
                ctx: ShardCtx):
    """The time loop from ``cache``, or from a cold state where it is None
    (and then only the hidden outputs come back, with a ``None`` state).
    On a running mesh ``pre`` is gathered whole over its gates once and
    the loop runs on each rank's local rows."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    rows = ("batch", None, None)
    return _map_cell(
        lambda r, pre, c0: slstm_steps(r.float(), pre, c0, cfg), ctx,
        (r, pre), ((None,) * 4, rows), 1, cache, (rows,) * 4,
        lambda r, pre: _cold_slstm(pre.shape[0], h, hd, pre.device))


def slstm_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: SLSTMCache | None = None, ctx: ShardCtx = NULL_CTX):
    """The sLSTM time loop over ``x (B, S, d)`` (already normed), then the
    gated feed-forward (pf 4/3, tanh GELU).  Returns ``(out (B, S, d),
    new_cache)``: None without a cache, else a new ``SLSTMCache``."""
    b, seq, d = x.shape
    # the input projection once over every row, outside the loop
    y, new_cache = _slstm_time(params["r"], _slstm_input(params, x), cache,
                               cfg, ctx)
    y = reshape_whole(y, (b, seq, d), 2, y.shape[2]).to(x.dtype)
    dt = x.dtype
    g = y @ params["ff_g"].to(dt)
    u = y @ params["ff_u"].to(dt)
    out = (F.gelu(g, approximate="tanh") * u) @ params["ff_o"].to(dt)
    out = ctx.constrain(out, ("batch", "seq_res", "embed_act"))
    return out, new_cache


def _cold_slstm(batch: int, h: int, hd: int, device=None) -> SLSTMCache:
    shape = (batch, h, hd)
    f32 = torch.float32
    return SLSTMCache(*(torch.zeros(shape, dtype=f32, device=device)
                        for _ in range(3)),
                      m=torch.full(shape, NEG, dtype=f32, device=device))


def slstm_cache_shape(cfg: ModelConfig, batch: int,
                      device=None) -> SLSTMCache:
    """A cold cache for one layer: zeros, the stabiliser at -1e30."""
    h = cfg.num_heads
    return _cold_slstm(batch, h, cfg.d_model // h, device)


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
