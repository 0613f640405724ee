"""Grouped-query attention with RoPE and a fixed-capacity KV cache.

The port of the GQA half of ``repro/models/attention.py`` (MLA comes with
the MoE slice).  Layouts follow the JAX package: activations ``(B, S, d)``,
heads ``(B, S, H, hd)``, cache ``(B, T, KV, hd)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import apply_rope


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, KV, hd)
    v: torch.Tensor  # (B, T, KV, hd)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 cache_index: torch.Tensor) -> torch.Tensor:
    """Write ``new (B, S, ...)`` at per-row start ``cache_index`` (clamped
    so the write fits, as ``lax.dynamic_update_slice`` clamps), in place."""
    b, s = new.shape[:2]
    t = cache.shape[1]
    start = torch.clamp(cache_index.long(), 0, t - s)
    pos = start[:, None] + torch.arange(s, device=cache.device)[None, :]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, s)
    cache[rows, pos] = new.to(cache.dtype)
    return cache


def gqa_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, cache: KVCache | None = None,
                  cache_index: torch.Tensor | None = None):
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

    new_cache = None
    if cache is None:
        out = kernel_ops.attention(q, k, v, causal=cfg.causal)
    else:
        k_all = _cache_write(cache.k, k, cache_index)
        v_all = _cache_write(cache.v, v, cache_index)
        new_cache = KVCache(k_all, v_all)
        if x.shape[1] == 1:
            kv_len = cache_index + 1
            out = kernel_ops.decode_attention(q[:, 0], k_all, v_all,
                                              kv_len)[:, None]
        else:
            out = kernel_ops.attention(q, k, v, causal=cfg.causal)
    out = out.reshape(out.shape[:2] + (h * cfg.head_dim_,))
    return out @ params["wo"].to(dt), new_cache


def gqa_cache_shape(cfg: ModelConfig, batch: int,
                    max_len: int) -> tuple[int, ...]:
    """Shape of one layer's K (and V) cache: ``(B, T, KV, hd)``."""
    return (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
