"""Shared layers: parameter declarations, RMSNorm, SwiGLU MLP, rotary
embeddings, embedding/head and the cross-entropy loss.

The port of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors laid out as in the JAX package (``(d_in, d_out)`` projection
matrices), so a JAX parameter tree converts leaf for leaf.  ``ctx`` (a
``ShardCtx``) constrains activations where the reference does; off a
running mesh that is a no-op.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ParamDecl,
    ShardCtx,
    shard_map_compat,
    shard_offset,
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


def _masked_sums(lse: torch.Tensor, gold: torch.Tensor,
                 targets: torch.Tensor):
    """Over the rows given: the summed f32 NLL, the summed squared
    log-partition and the count of targets (``-1`` ignored)."""
    mask = (targets >= 0).float()
    return ((lse - gold) * mask).sum(), (lse ** 2 * mask).sum(), mask.sum()


def _ce_sums(logits: torch.Tensor, targets: torch.Tensor):
    """``_masked_sums`` of logits whose vocab is whole."""
    logits = logits.float()
    safe_t = torch.clamp(targets, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_t[..., None])[..., 0]
    return _masked_sums(lse, gold, targets)


class _ShardLogPartition(torch.autograd.Function):
    """Per row of one rank's vocab shard ``[v0, v0 + V_local)``: the f32
    log-partition over the whole vocab and the target's logit (0 on the
    ranks whose shard does not hold it), from one all-reduce of the row
    maxima (MAX) and one of the pair ``(sum exp(x - m), gold)`` (SUM) over
    each group in ``groups``.  The maxima are a shift only and carry no
    gradient; the backward issues no collective: ``g_lse * softmax +
    g_gold * onehot`` on the shard, from the saved log-partition."""

    @staticmethod
    def forward(ctx, logits, targets, v0: int, groups):
        m = logits.detach().amax(-1).float()
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        # as torch.logsumexp: an infinite maximum shifts by 0
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        local = targets.long() - v0
        own = (local >= 0) & (local < logits.shape[-1])
        idx = torch.where(own, local, 0)[..., None]
        pair = torch.stack([
            torch.sub(logits, m[..., None]).exp_().sum(-1),
            torch.where(own, torch.gather(logits, -1, idx)[..., 0].float(),
                        0.0)])
        for g in groups:
            dist.all_reduce(pair, group=g)
        lse = pair[0].log() + m
        ctx.save_for_backward(logits, lse, idx, own)
        return lse, pair[1]

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        logits, lse, idx, own = ctx.saved_tensors
        grad = torch.sub(logits, lse[..., None]).exp_().mul_(g_lse[..., None])
        grad.scatter_add_(-1, idx, torch.where(own, g_gold, 0.0)[..., None])
        return grad.to(logits.dtype), None, None, None


def _vocab_groups(logits) -> list | None:
    """The process groups of the mesh dims of more than one rank that
    split the last dim of the DTensor ``logits``; None where there is none
    or the split is uneven (``local_map`` takes even shards)."""
    mesh = logits.device_mesh
    dims = [i for i, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim == logits.ndim - 1
            and mesh.size(i) > 1]
    n = math.prod(mesh.size(i) for i in dims)
    if not dims or logits.shape[-1] % n:
        return None
    return [mesh.get_group(i) for i in dims]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 0.0,
                  ctx: ShardCtx = NULL_CTX) -> tuple[torch.Tensor, dict]:
    """Stable cross entropy in f32 plus ``z_loss`` times the mean squared
    log-partition; targets ``-1`` are ignored.  Returns ``(loss, {"nll",
    "z", "tokens"})``.  On a mesh the logits stay split as ``lm_logits``
    leaves them, rows and vocab (``("batch", "seq", "vocab_act")``), and
    each rank sums over its own rows and vocab shard in ``local_map``
    (``_ShardLogPartition``: two all-reduces over the mesh dims that split
    the vocab); the sums are partial over the mesh dims that split the
    rows.  Where no mesh dim of more than one rank splits the vocab, or
    its split is uneven (a test mesh whose "model" does not divide the
    padded vocab), the vocab is gathered whole first and each rank sums
    over its rows with the unsharded code (no collective over a mesh dim
    of one)."""
    if ctx.running:
        logits = ctx.constrain(logits, ("batch", "seq", "vocab_act"))
        targets = ctx.constrain(targets, ("batch", "seq"))
        groups = _vocab_groups(logits)
        if groups is None:
            logits = ctx.constrain(logits, ("batch", "seq", None))
            fn = _ce_sums
        else:
            v0 = shard_offset(logits.shape, logits.device_mesh,
                              logits.placements)[-1]

            def fn(lg, tg):
                return _masked_sums(
                    *_ShardLogPartition.apply(lg, tg, v0, groups), tg)
        rows = tuple(Partial() if isinstance(p, Shard)
                     and p.dim < logits.ndim - 1 else Replicate()
                     for p in logits.placements)
        sums = shard_map_compat(
            fn, ctx.device_mesh,
            in_specs=(tuple(logits.placements), tuple(targets.placements)),
            out_specs=[rows] * 3)
        nll, zl, count = sums(logits, targets)
    else:
        nll, zl, count = _ce_sums(logits, targets)
    denom = torch.clamp(count, min=1.0)
    loss = nll / denom
    zl = zl / denom
    return loss + z_loss * zl, {"nll": loss, "z": zl, "tokens": denom}
