"""Shared layers: RMSNorm, SwiGLU MLP, rotary embeddings, embedding/head.

The port of ``repro/models/layers.py`` for the dense family.  Parameters are
plain dicts of tensors laid out as in the JAX package (``(d_in, d_out)``
projection matrices), so a JAX parameter tree converts leaf for leaf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation (and parameter) dtype of a config."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return kernel_ops.rmsnorm(x, params["scale"], eps)


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (``silu(x W_g) * (x W_u)) W_o``) or GELU MLP."""
    dt = x.dtype
    if "wi_g" in params:
        g = x @ params["wi_g"].to(dt)
        u = x @ params["wi_u"].to(dt)
        h = F.silu(g) * u
    else:
        h = F.gelu(x @ params["wi"].to(dt), approximate="tanh")
    return h @ params["wo"].to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x ``(B, S, H, hd)``; positions ``(B, S)``.  Angles in f32, the
    rotation in the activation dtype (llama convention: rotate halves)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return params["embedding"].to(act_dtype(cfg))[tokens]


def lm_logits(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(x.dtype).t()
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits
