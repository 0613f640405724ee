"""Attention variants: grouped-query attention with RoPE and DeepSeek-V2's
multi-head latent attention (MLA), each with a fixed-capacity cache.

The port of ``repro/models/attention.py``.  Layouts follow the JAX package:
activations ``(B, S, d)``, heads ``(B, S, H, hd)``, GQA cache ``(B, T, KV,
hd)``, MLA cache the latents ``c_kv (B, T, kv_lora_rank)`` and ``k_pe (B,
T, qk_rope_dim)``.

MLA has two decode paths, as in the reference: the naive one rebuilds the
per-head K and V from the cached latents every step and calls the decode
kernel at head dim ``qk_nope + qk_rope`` (v zero-padded to that width, the
reference's layout, and sliced after); the absorbed one
(``cfg.mla.absorbed_decode``) folds ``W_uk`` into the query and ``W_uv``
after the attention and attends in the latent space with plain einsums.

``ctx`` constrains q, k, the output and the caches where the reference
does.  On a mesh the caches are DTensors: a write lands on the ranks whose
slice of the cache's length holds its positions (``_cache_write``), and
prefill attends over the step's own head-split k/v while it writes the
length-split cache of ``PREFILL_RULES``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import ParamDecl, apply_rope
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ShardCtx,
    redistribute,
    shard_offset,
)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, KV, hd)  or MLA: c_kv (B, T, rank)
    v: torch.Tensor  # (B, T, KV, hd)  or MLA: k_pe (B, T, rope_dim)


def gqa_decl(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"wq": ParamDecl((d, cfg.attn_dim), ("embed", "heads")),
            "wk": ParamDecl((d, cfg.kv_dim), ("embed", "kv")),
            "wv": ParamDecl((d, cfg.kv_dim), ("embed", "kv")),
            "wo": ParamDecl((cfg.attn_dim, d), ("heads", "embed"))}


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def _attn_kw(cfg: ModelConfig) -> dict:
    """The config's attention route and flash_xla tiling (``ops.attention``
    ``impl``, ``block_q``, ``block_kv``, ``unroll``)."""
    return dict(impl=cfg.attn_impl, block_q=cfg.attn_block_q,
                block_kv=cfg.attn_block_kv, unroll=cfg.attn_unroll)


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 cache_index: torch.Tensor) -> torch.Tensor:
    """Write ``new (B, S, ...)`` at per-row start ``cache_index`` (clamped
    so the write fits, as ``lax.dynamic_update_slice`` clamps), in place."""
    if isinstance(cache, DTensor):
        return _cache_write_sharded(cache, new, cache_index)
    b, s = new.shape[:2]
    t = cache.shape[1]
    start = torch.clamp(cache_index.long(), 0, t - s)
    pos = start[:, None] + torch.arange(s, device=cache.device)[None, :]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    cache[rows, pos] = new.to(cache.dtype)
    return cache


def _cache_write_sharded(cache, new, cache_index):
    """``_cache_write`` on a DTensor cache: each rank writes the positions
    its slice of the length holds (the new rows laid out as the cache,
    whole along the length); a one-token write is an indexed store, a
    longer one a select over the local slice.  No host read."""
    mesh, cp = cache.device_mesh, tuple(cache.placements)
    npl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in cp)
    ipl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in cp)
    new_l = redistribute(new.to(cache.dtype), mesh, npl).to_local()
    idx_l = redistribute(cache_index, mesh, ipl).to_local().long()
    c_l = cache.to_local()
    t, t0 = cache.shape[1], shard_offset(cache.shape, mesh, cp)[1]
    b, s = new_l.shape[:2]
    dev = c_l.device
    start = torch.clamp(idx_l, 0, t - s)
    rows = torch.arange(b, device=dev)[:, None]
    if s == 1:
        pos = start[:, None] - t0
        ok = (pos >= 0) & (pos < c_l.shape[1])
        pos = torch.clamp(pos, 0, c_l.shape[1] - 1)
        keep = c_l[rows, pos]
        sel = ok.reshape(ok.shape + (1,) * (keep.ndim - 2))
        c_l[rows, pos] = torch.where(sel, new_l, keep)
        return cache
    j = torch.arange(c_l.shape[1], device=dev)[None, :] + t0 - start[:, None]
    ok = (j >= 0) & (j < s)
    got = new_l[rows, torch.clamp(j, 0, s - 1)]
    c_l.copy_(torch.where(ok.reshape(ok.shape + (1,) * (c_l.ndim - 2)), got,
                          c_l))
    return cache


def _pad_last(x, n: int):
    """``x`` zero-padded by ``n`` on its last dim.  A DTensor (whose last
    dim is whole) is padded shard by shard: DTensor's own rule for the pad
    fails to plan its redistribution on some PyTorch versions."""
    if not isinstance(x, DTensor):
        return F.pad(x, (0, n))
    if any(isinstance(p, Shard) and p.dim == x.ndim - 1
           for p in x.placements):
        raise ValueError("padding a split last dim")
    local = F.pad(x.to_local(), (0, n))
    shape = x.shape[:-1] + (x.shape[-1] + n,)
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def gqa_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, cache: KVCache | None = None,
                  cache_index: torch.Tensor | None = None,
                  ctx: ShardCtx = NULL_CTX):
    """Returns ``(out (B, S, d), new_cache)``.

    With a cache the step's k/v are written at ``cache_index`` IN PLACE
    (the cache passed in is updated and returned; the JAX package returns
    a new buffer).  Decode (S == 1) attends over the cache with
    ``kv_length = cache_index + 1``; prefill attends causally over the step's
    own k/v, which are numerically the written ``[0, S)`` prefix."""
    dt = x.dtype
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(x @ params["wq"].to(dt), h)
    k = _split_heads(x @ params["wk"].to(dt), kv)
    v = _split_heads(x @ params["wv"].to(dt), kv)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = ctx.constrain(q, ("batch", "seq", "heads_act", None))
    k = ctx.constrain(k, ("batch", "seq", "kv_heads_act", None))
    v = ctx.constrain(v, ("batch", "seq", "kv_heads_act", None))

    new_cache = None
    if cache is None:
        out = kernel_ops.attention(q, k, v, causal=cfg.causal,
                                   **_attn_kw(cfg))
    else:
        k_all = _cache_write(cache.k, k, cache_index)
        v_all = _cache_write(cache.v, v, cache_index)
        new_cache = KVCache(k_all, v_all)
        if x.shape[1] == 1:
            kv_len = cache_index + 1
            out = kernel_ops.decode_attention(q[:, 0], k_all, v_all,
                                              kv_len)[:, None]
        else:
            out = kernel_ops.attention(q, k, v, causal=cfg.causal,
                                       **_attn_kw(cfg))
    out = ctx.constrain(out, ("batch", "seq", "heads_act", None))
    out = out.reshape(out.shape[:2] + (h * cfg.head_dim_,))
    return ctx.constrain(out @ params["wo"].to(dt),
                         ("batch", "seq_res", "embed_act")), new_cache


def gqa_cache_shape(cfg: ModelConfig, batch: int,
                    max_len: int) -> tuple[int, ...]:
    """Shape of one layer's K (and V) cache: ``(B, T, KV, hd)``."""
    return (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 family)
# ---------------------------------------------------------------------------


def mla_decl(cfg: ModelConfig) -> dict:
    d, h, m = cfg.d_model, cfg.num_heads, cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": ParamDecl((d, h * qk), ("embed", "heads")),
        "w_dkv": ParamDecl((d, m.kv_lora_rank + m.qk_rope_dim),
                           ("embed", "lora")),
        "kv_norm": ParamDecl((m.kv_lora_rank,), ("lora",), "ones"),
        "w_uk": ParamDecl((m.kv_lora_rank, h * m.qk_nope_dim),
                          ("lora", "heads")),
        "w_uv": ParamDecl((m.kv_lora_rank, h * m.v_head_dim),
                          ("lora", "heads")),
        "wo": ParamDecl((h * m.v_head_dim, d), ("heads", "embed")),
    }


def _mla_compress(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor):
    """x -> (``c_kv`` normalized, ``k_pe`` with RoPE): what the cache holds.
    ``kv_norm`` is the rmsnorm kernel at width ``kv_lora_rank`` over a
    strided slice of the ``w_dkv`` output (the op copies it contiguous)."""
    m = cfg.mla
    dkv = x @ params["w_dkv"].to(x.dtype)
    c_kv, k_pe = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    c_kv = kernel_ops.rmsnorm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, cache: KVCache | None = None,
                  cache_index: torch.Tensor | None = None,
                  ctx: ShardCtx = NULL_CTX):
    """Returns ``(out (B, S, d), new_cache)``.  With a cache, the step's
    ``(c_kv, k_pe)`` are written at ``cache_index`` IN PLACE.  Prefill
    (S > 1) attends causally over the step's own latents; decode (S == 1)
    over the whole cache with ``kv_length = cache_index + 1``."""
    dt = x.dtype
    h, m = cfg.num_heads, cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    q = _split_heads(x @ params["wq"].to(dt), h)
    q_nope, q_pe = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    q_nope = ctx.constrain(q_nope, ("batch", "seq", "heads_act", None))
    c_kv, k_pe = _mla_compress(params, x, cfg, positions)

    new_cache, kv_len = None, None
    decode = cache is not None and x.shape[1] == 1
    if cache is not None:
        c_all = ctx.constrain(_cache_write(cache.k, c_kv, cache_index),
                              ("batch", "kv_seq", "lora"))
        pe_all = _cache_write(cache.v, k_pe, cache_index)
        new_cache = KVCache(c_all, pe_all)
        kv_len = cache_index + x.shape[1]
        if decode:
            c_kv, k_pe = c_all, pe_all

    if m.absorbed_decode and decode:
        # attend in the kv_lora_rank-wide latent space
        w_uk = params["w_uk"].to(dt).reshape(m.kv_lora_rank, h,
                                             m.qk_nope_dim)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
        s_lat = torch.einsum("bshr,btr->bhst", q_lat, c_kv.to(dt))
        s_pe = torch.einsum("bshp,btp->bhst", q_pe, k_pe.to(dt))
        logits = (s_lat + s_pe).float() * qk ** -0.5
        tpos = torch.arange(c_kv.shape[1], device=x.device)
        mask = tpos[None, None, None, :] < kv_len[:, None, None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1).to(dt)
        o_lat = torch.einsum("bhst,btr->bshr", probs, c_kv.to(dt))
        w_uv = params["w_uv"].to(dt).reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
    else:
        # naive path: per-head K and V rebuilt from the latents
        k_nope = _split_heads(c_kv.to(dt) @ params["w_uk"].to(dt), h)
        v = _split_heads(c_kv.to(dt) @ params["w_uv"].to(dt), h)
        k_pe_b = k_pe.to(dt)[:, :, None, :].expand(
            k_nope.shape[:3] + (m.qk_rope_dim,))
        k_full = torch.cat([k_nope, k_pe_b], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        # v padded to the qk width so one kernel instance serves both
        # products; the pad is sliced off below
        v_pad = _pad_last(v, qk - m.v_head_dim)
        if decode:
            out = kernel_ops.decode_attention(q_full[:, 0], k_full, v_pad,
                                              kv_len)[:, None]
        else:
            out = kernel_ops.attention(q_full, k_full, v_pad,
                                       causal=cfg.causal, **_attn_kw(cfg))
        out = out[..., :m.v_head_dim]
    out = out.reshape(out.shape[:2] + (h * m.v_head_dim,))
    return ctx.constrain(out @ params["wo"].to(dt),
                         ("batch", "seq_res", "embed_act")), new_cache


def mla_cache_shapes(cfg: ModelConfig, batch: int,
                     max_len: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of one layer's MLA cache: ``c_kv (B, T, rank)`` and ``k_pe
    (B, T, rope_dim)``."""
    m = cfg.mla
    return ((batch, max_len, m.kv_lora_rank),
            (batch, max_len, m.qk_rope_dim))
