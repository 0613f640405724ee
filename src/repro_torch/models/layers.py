"""Shared layers: parameter declarations, RMSNorm, SwiGLU MLP, rotary
embeddings, embedding/head and the cross-entropy loss.

The port of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors laid out as in the JAX package (``(d_in, d_out)`` projection
matrices), so a JAX parameter tree converts leaf for leaf.  ``ctx`` (a
``ShardCtx``) constrains activations where the reference does; off a
running mesh that is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ParamDecl,
    ShardCtx,
    shard_map_compat,
)


def embed_decl(cfg: ModelConfig) -> dict:
    """The token embedding (``normal`` 0.02) and, without tied
    embeddings, the LM head."""
    d = {"embedding": ParamDecl((cfg.padded_vocab, cfg.d_model),
                                ("vocab", "embed"), "normal", 0.02)}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDecl((cfg.d_model, cfg.padded_vocab),
                                 ("embed", "vocab"))
    return d


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


def mlp(params: dict, x: torch.Tensor,
        ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """SwiGLU (``silu(x W_g) * (x W_u)) W_o``) or GELU MLP."""
    dt = x.dtype
    if "wi_g" in params:
        g = x @ params["wi_g"].to(dt)
        u = x @ params["wi_u"].to(dt)
        h = F.silu(g) * u
    else:
        h = F.gelu(x @ params["wi"].to(dt), approximate="tanh")
    h = ctx.constrain(h, ("batch", "seq", "mlp_act"))
    return ctx.constrain(h @ params["wo"].to(dt),
                         ("batch", "seq_res", "embed_act"))


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


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    if ctx.running:
        # a vocab-split table gives masked partial rows: summed here
        tokens = ctx.constrain(tokens, ("batch", "seq"))
        x = F.embedding(tokens, params["embedding"].to(act_dtype(cfg)))
        return ctx.constrain(x, ("batch", "seq", "embed_act"))
    return params["embedding"].to(act_dtype(cfg))[tokens]


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(x.dtype).t()
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return ctx.constrain(logits, ("batch", "seq", "vocab_act"))


def _ce_sums(logits: torch.Tensor, targets: torch.Tensor):
    """Over the rows given: the summed f32 NLL, the summed squared
    log-partition and the count of targets (``-1`` ignored)."""
    logits = logits.float()
    mask = (targets >= 0).float()
    safe_t = torch.clamp(targets, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_t[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), (lse ** 2 * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 0.0,
                  ctx: ShardCtx = NULL_CTX) -> tuple[torch.Tensor, dict]:
    """Stable cross entropy in f32 plus ``z_loss`` times the mean squared
    log-partition; targets ``-1`` are ignored.  Returns ``(loss, {"nll",
    "z", "tokens"})``.  On a mesh the vocab is gathered first (DTensor has
    no rule for a gather along a split vocab) and each rank sums over its
    own rows (``local_map``; the sums are partial over the mesh dims that
    split the rows): run as DTensor ops, the gather's backward would make
    a zero gradient of the whole global logits on every rank."""
    if ctx.running:
        logits = ctx.constrain(logits, ("batch", "seq", None))
        targets = ctx.constrain(targets, ("batch", "seq"))
        rows = tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in logits.placements)
        sums = shard_map_compat(
            _ce_sums, ctx.device_mesh,
            in_specs=(tuple(logits.placements), tuple(targets.placements)),
            out_specs=[rows] * 3)
        nll, zl, count = sums(logits, targets)
    else:
        nll, zl, count = _ce_sums(logits, targets)
    denom = torch.clamp(count, min=1.0)
    loss = nll / denom
    zl = zl / denom
    return loss + z_loss * zl, {"nll": loss, "z": zl, "tokens": denom}
