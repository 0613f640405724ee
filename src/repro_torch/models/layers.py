"""Shared layers: parameter declarations, RMSNorm, SwiGLU MLP, rotary
embeddings, embedding/head and the cross-entropy loss.

The port of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors laid out as in the JAX package (``(d_in, d_out)`` projection
matrices), so a JAX parameter tree converts leaf for leaf.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of one parameter tensor: its shape, the logical axis
    name of each dimension (``parallel/sharding.py`` maps them onto a
    mesh) and its initializer.  The JAX package's ParamDecl without the
    storage dtype: every leaf takes the model's dtype, as the JAX
    package's ``init_tree`` casts it."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "fan_in"  # fan_in | ones | zeros | normal
    scale: float = 1.0

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def norm_decl(dim: int) -> dict:
    return {"scale": ParamDecl((dim,), ("embed",), "ones")}


def mlp_decl(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    """SwiGLU (``act == "silu"``) or GELU MLP of width ``d_ff`` (default
    ``cfg.d_ff``)."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {"wi_g": ParamDecl((d, ff), ("embed", "mlp")),
                "wi_u": ParamDecl((d, ff), ("embed", "mlp")),
                "wo": ParamDecl((ff, d), ("mlp", "embed"))}
    return {"wi": ParamDecl((d, ff), ("embed", "mlp")),
            "wo": ParamDecl((ff, d), ("mlp", "embed"))}


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


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 0.0) -> tuple[torch.Tensor, dict]:
    """Stable cross entropy in f32 plus ``z_loss`` times the mean squared
    log-partition; targets ``-1`` are ignored.  Returns ``(loss, {"nll",
    "z", "tokens"})``."""
    logits = logits.float()
    mask = (targets >= 0).float()
    safe_t = torch.clamp(targets, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_t[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    zl = (lse ** 2 * mask).sum() / denom
    return loss + z_loss * zl, {"nll": loss, "z": zl, "tokens": denom}
