"""The dense-family SHINE DEQ language model: parameters and serving.

The port of the dense DEQ path of ``repro/models/lm.py``.  The layer stack
is a weight-tied group of ``cfg.deq.num_blocks`` attention+SwiGLU blocks
solved to a fixed point with input injection,

    z* = x + C(z*),   C(z) = blocks(z) - z,

by the registered forward solver (Broyden, whose inverse estimate is
SHINE's shared object).  This slice serves: :func:`prefill` solves the
prompt's equilibrium against a fresh KV cache and seeds the decode carry
with its last token; :func:`decode_step` solves one new token per row
against the frozen cache (inactive rows frozen in the batched solve), warm
started from the carried equilibrium and quasi-Newton ring, then refreshes
the cache once at ``z*``.  ``forward``/``loss_fn`` and the other families
come with later slices.

Parameters are a plain dict with the JAX package's tree and layouts, so
:func:`params_from_jax` converts a JAX ``init_params`` tree leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.solvers import SolveCarry, init_solve_carry, seed_carry
from repro_torch.device import resolve_device
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.engine import batched_solve
from repro_torch.implicit.fixed_point import implicit_fixed_point
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    act_dtype,
    embed_tokens,
    lm_logits,
    mlp,
    rmsnorm,
)

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declaration of one parameter tensor (the JAX package's ParamDecl
    without the sharding axes)."""

    shape: tuple[int, ...]
    init: str = "fan_in"  # fan_in | ones | normal
    scale: float = 1.0


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"repro_torch serves the dense GQA family so far; {cfg.name} is "
            f"{cfg.family}/{cfg.attn_type}")
    if not cfg.deq.enabled:
        raise NotImplementedError(
            "repro_torch serves the DEQ model so far (cfg.deq.enabled); the "
            "layer-stack path comes with a later slice")


def _stack(decl: dict, count: int) -> dict:
    return {k: (_stack(v, count) if isinstance(v, dict) else
                ParamDecl((count,) + v.shape, v.init, v.scale))
            for k, v in decl.items()}


def _unit_decl(cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    mlp_decl = ({"wi_g": ParamDecl((d, ff)), "wi_u": ParamDecl((d, ff)),
                 "wo": ParamDecl((ff, d))} if cfg.act == "silu" else
                {"wi": ParamDecl((d, ff)), "wo": ParamDecl((ff, d))})
    return {
        "ln1": {"scale": ParamDecl((d,), "ones")},
        "attn": {"wq": ParamDecl((d, cfg.attn_dim)),
                 "wk": ParamDecl((d, cfg.kv_dim)),
                 "wv": ParamDecl((d, cfg.kv_dim)),
                 "wo": ParamDecl((cfg.attn_dim, d))},
        "ln2": {"scale": ParamDecl((d,), "ones")},
        "mlp": mlp_decl,
    }


def model_decl(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    embed = {"embedding": ParamDecl((cfg.padded_vocab, cfg.d_model),
                                    "normal", 0.02)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = ParamDecl((cfg.d_model, cfg.padded_vocab))
    return {"embed": embed,
            "final_norm": {"scale": ParamDecl((cfg.d_model,), "ones")},
            "deq_blocks": _stack(_unit_decl(cfg), cfg.deq.num_blocks)}


def _init_leaf(d: ParamDecl, gen: torch.Generator, device) -> torch.Tensor:
    if d.init == "ones":
        return torch.ones(d.shape, device=device)
    if d.init == "normal":
        return d.scale * torch.randn(d.shape, generator=gen, device=device)
    if d.init == "fan_in":
        # fan-in = product of all dims except the last (as the JAX
        # package's ParamDecl, stacked layer axis included); standard
        # normal truncated to [-2, 2], scaled
        fan_in = max(1, math.prod(d.shape[:-1])) if len(d.shape) > 1 \
            else d.shape[0]
        std = d.scale / math.sqrt(fan_in)
        out = torch.empty(d.shape, device=device)
        return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std,
                                           2.0 * std, generator=gen)
    raise ValueError(f"unknown init {d.init!r}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's shapes and distributions
    (``fan_in`` truncated normal, ``normal`` 0.02 embedding, ``ones``
    norms), drawn from a ``torch.Generator`` seeded with ``seed`` on the
    target device, in the config's dtype.  The numbers differ from JAX's
    for the same seed; tests carry JAX's over with :func:`params_from_jax`.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = act_dtype(cfg)

    def build(decl):
        return {k: (build(v) if isinstance(v, dict) else
                    _init_leaf(v, gen, dev).to(dtype))
                for k, v in decl.items()}

    return build(model_decl(cfg))


def params_from_jax(np_params: dict, device=None) -> dict:
    """Convert the JAX ``init_params`` tree, as numpy arrays, to the port's
    tree (same keys, same layouts).  bf16 leaves (numpy's ml_dtypes
    bfloat16) stay bf16."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return conv(np_params)


def params_device(params: dict) -> torch.device:
    return params["embed"]["embedding"].device


# ---------------------------------------------------------------------------
# Block application and the DEQ solve
# ---------------------------------------------------------------------------


def apply_unit(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cache=None, cache_index=None):
    """One pre-norm attention + SwiGLU block.  Returns ``(x, new_cache)``."""
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    a_out, new_kv = attn.gqa_attention(
        params["attn"], rmsnorm(params["ln1"], x, cfg.norm_eps), cfg,
        positions, cache, cache_index)
    x = x + a_out
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, new_kv


def _block(p_blocks: dict, j: int) -> dict:
    return {k: (_block(v, j) if isinstance(v, dict) else v[j])
            for k, v in p_blocks.items()}


def _deq_cfg(cfg: ModelConfig) -> ImplicitConfig:
    d = cfg.deq
    return ImplicitConfig.from_strings(
        solver=d.solver, max_steps=d.max_steps, tol=d.tol, memory=d.memory,
        backward=d.backward, refine_steps=d.refine_steps,
        backward_max_steps=d.backward_max_steps, unroll=d.unroll,
        qn_dtype=d.qn_dtype, guard=d.guard)


def deq_solve_carry(cfg: ModelConfig, batch: int, seq: int,
                    device=None) -> SolveCarry:
    """An all-cold persistent solve state for the DEQ group's ``(B, S, d)``
    activations."""
    return init_solve_carry(batch, (seq, cfg.d_model), cfg.deq.memory,
                            dtype=act_dtype(cfg), qn_dtype=cfg.deq.qn_dtype,
                            device=resolve_device(device))


def _apply_deq(params, x_emb, cfg, positions, caches, cache_index,
               active=None, carry=None):
    """Solve the weight-tied block group's fixed point for the new tokens
    against the (frozen) KV cache, then refresh the cache once at z*.
    Returns ``(z*, caches, aux)``."""
    nb = cfg.deq.num_blocks
    blocks = [_block(params["deq_blocks"], j) for j in range(nb)]
    kc, vc = caches["deq"]

    def f_dec(p, xin, z):
        x_in, pos, cidx = xin
        h = z
        for j in range(nb):
            h, _ = apply_unit("attn_mlp", p[j], h, cfg, pos,
                              attn.KVCache(kc[j], vc[j]), cidx)
        return x_in + (h - z)

    # cold start AT the injection: f(x) = x + C(x) is one free Picard step
    z0 = x_emb
    xin = (x_emb, positions, cache_index)
    if active is not None:
        out = batched_solve(f_dec, blocks, xin, z0, _deq_cfg(cfg),
                            valid=active, carry=carry)
    else:
        out = implicit_fixed_point(f_dec, blocks, xin, z0, _deq_cfg(cfg),
                                   carry=carry)
    z_star, stats = out[0], out[1]
    # one more pass writes the caches at the fixed point (the state IS the
    # block-input stream under input injection)
    h = z_star
    for j in range(nb):
        h, _ = apply_unit("attn_mlp", blocks[j], h, cfg, positions,
                          attn.KVCache(kc[j], vc[j]), cache_index)
    aux = {"deq_residual": stats.residual.mean(),
           "deq_steps": float(stats.n_steps)}
    if stats.status is not None:
        aux["deq_status"] = stats.status
    if carry is not None:
        aux["solve_carry"] = out[2]
    return z_star, caches, aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """``{"deq": KVCache(k, v)}`` with k/v ``(num_blocks, B, max_len, KV,
    hd)`` zeros."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.deq.num_blocks,) + attn.gqa_cache_shape(cfg, batch, max_len)
    dt = act_dtype(cfg)
    return {"deq": attn.KVCache(torch.zeros(shape, dtype=dt, device=dev),
                                torch.zeros(shape, dtype=dt, device=dev))}


@torch.no_grad()
def prefill(params, batch: dict, cfg: ModelConfig, max_len: int, *,
            carry: SolveCarry | None = None, return_steps: bool = False,
            return_status: bool = False):
    """Encode a prompt ``batch["tokens"] (B, S)``; returns ``(logits (B, S,
    V), caches, lengths)``.

    ``carry`` (a decode-shaped ``deq_solve_carry(cfg, B, 1)``) is seeded
    with the last token's equilibrium and appended to the return, so the
    first decode step warm-starts.  ``return_steps`` appends the prefill
    solve's step count and ``return_status`` its per-row health codes
    (``core.solvers.STATUS_*``)."""
    _check_family(cfg)
    dev = params_device(params)
    tokens = batch["tokens"].to(dev)
    x = embed_tokens(params["embed"], tokens, cfg)
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    caches = init_cache(cfg, b, max_len, dev)
    idx0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    z, caches, aux = _apply_deq(params, x, cfg, pos, caches, idx0)
    z_last = z[:, -1:, :]
    x = rmsnorm(params["final_norm"], z, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = (logits, caches, lengths)
    if carry is not None:
        out = out + (seed_carry(carry, z_last),)
    if return_steps:
        out = out + (aux["deq_steps"],)
    if return_status:
        out = out + (aux["deq_status"] if "deq_status" in aux else
                     torch.zeros((b,), dtype=torch.int32, device=dev),)
    return out


@torch.no_grad()
def decode_step(params, caches, tokens: torch.Tensor,
                cache_index: torch.Tensor, cfg: ModelConfig, *,
                active: torch.Tensor | None = None,
                carry: SolveCarry | None = None, return_steps: bool = False,
                return_status: bool = False):
    """One decode step: tokens ``(B,)`` at ``cache_index (B,)``.  Returns
    ``(logits (B, V), caches)``, plus the updated carry when ``carry`` is
    given, the solver's step count (``return_steps``) and the per-row
    health codes (``return_status``).  ``active: (B,) bool`` freezes
    finished/empty slots in the solve.  The caches are updated in place."""
    _check_family(cfg)
    x = embed_tokens(params["embed"], tokens[:, None], cfg)
    pos = cache_index[:, None].int()
    z, caches, aux = _apply_deq(params, x, cfg, pos, caches, cache_index,
                                active=active, carry=carry)
    x = rmsnorm(params["final_norm"], z, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg)
    out = ((logits[:, 0], caches) if carry is None
           else (logits[:, 0], caches, aux.get("solve_carry", carry)))
    if return_steps:
        out = out + (aux["deq_steps"],)
    if return_status:
        out = out + (aux["deq_status"] if "deq_status" in aux else
                     torch.zeros((tokens.shape[0],), dtype=torch.int32,
                                 device=tokens.device),)
    return out
