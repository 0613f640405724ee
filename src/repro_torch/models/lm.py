"""The dense-family SHINE DEQ language model: parameters and serving.

The port of the dense DEQ path of ``repro/models/lm.py``.  The layer stack
is a weight-tied group of ``cfg.deq.num_blocks`` attention+SwiGLU blocks
solved to a fixed point with input injection,

    z* = x + C(z*),   C(z) = blocks(z) - z,

by the registered forward solver (Broyden, whose inverse estimate is
SHINE's shared object).  Training: :func:`forward` and :func:`loss_fn`
solve the whole sequence causally, and the backward runs the configured
SHINE-family estimator (``implicit_fixed_point``).  Serving:
:func:`prefill` solves the prompt's equilibrium against a fresh KV cache
(cold, or seeded from a cross-request prefix-cache snapshot assembled by
:func:`prefix_seed_carry` or :func:`prefix_gather_carry`) and seeds the
decode carry with its last token; :func:`decode_step` solves
one new token per row against the frozen cache (inactive rows frozen in the
batched solve), warm started from the carried equilibrium and quasi-Newton
ring, then refreshes the cache once at ``z*``.  The other families come
with later slices.

Parameters are a plain dict with the JAX package's tree and layouts, so
:func:`params_from_jax` converts a JAX ``init_params`` tree leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowrank import LowRank
from repro_torch.core.solvers import SolveCarry, init_solve_carry, seed_carry
from repro_torch.device import resolve_device, to_device
from repro_torch.implicit.config import ImplicitConfig
from repro_torch.implicit.engine import batched_solve
from repro_torch.implicit.fixed_point import implicit_fixed_point
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    act_dtype,
    cross_entropy,
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


def _deq_aux(out, carry) -> dict:
    """The solve's aux outputs from ``implicit_fixed_point``'s return."""
    stats = out[1]
    aux = {"deq_residual": stats.residual.mean(),
           "deq_steps": float(stats.n_steps)}
    if stats.status is not None:
        aux["deq_status"] = stats.status
    if carry is not None:
        aux["solve_carry"] = out[2]
    return aux


def _apply_deq(params, x_emb, cfg, positions, caches=None, cache_index=None,
               active=None, carry=None):
    """Solve the weight-tied block group's fixed point.  Without caches
    (training) the whole sequence attends causally over its own k/v and the
    solve is differentiable; with caches the new tokens attend over the
    frozen cache, which is refreshed once at ``z*``.  Returns ``(z*,
    caches, aux)``."""
    nb = cfg.deq.num_blocks
    # cold start AT the injection: f(x) = x + C(x) is one free Picard step
    z0 = x_emb
    if caches is None:
        def f(p, xin, z):
            x_in, pos = xin
            h = z
            for j in range(nb):
                h, _ = apply_unit("attn_mlp", _block(p["blocks"], j), h, cfg,
                                  pos)
            return x_in + (h - z)

        out = implicit_fixed_point(f, {"blocks": params["deq_blocks"]},
                                   (x_emb, positions), z0, _deq_cfg(cfg),
                                   carry=carry)
        return out[0], None, _deq_aux(out, carry)

    blocks = [_block(params["deq_blocks"], j) for j in range(nb)]
    kc, vc = caches["deq"]

    def f_dec(p, xin, z):
        x_in, pos, cidx = xin
        h = z
        for j in range(nb):
            h, _ = apply_unit("attn_mlp", p[j], h, cfg, pos,
                              attn.KVCache(kc[j], vc[j]), cidx)
        return x_in + (h - z)

    xin = (x_emb, positions, cache_index)
    if active is not None:
        out = batched_solve(f_dec, blocks, xin, z0, _deq_cfg(cfg),
                            valid=active, carry=carry)
    else:
        out = implicit_fixed_point(f_dec, blocks, xin, z0, _deq_cfg(cfg),
                                   carry=carry)
    z_star = out[0]
    # one more pass writes the caches at the fixed point (the state IS the
    # block-input stream under input injection)
    h = z_star
    for j in range(nb):
        h, _ = apply_unit("attn_mlp", blocks[j], h, cfg, positions,
                          attn.KVCache(kc[j], vc[j]), cache_index)
    return z_star, caches, _deq_aux(out, carry)


# ---------------------------------------------------------------------------
# Training: full-sequence forward and loss
# ---------------------------------------------------------------------------


def forward(params, batch: dict, cfg: ModelConfig,
            carry: SolveCarry | None = None):
    """Full-sequence forward of ``batch["tokens"] (B, S)``.  Returns
    ``(logits (B, S, V), aux)``; ``carry`` warm-starts the DEQ solve and
    the updated one comes back under ``aux["solve_carry"]``."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        b, s)
    z, _, aux = _apply_deq(params, x, cfg, pos, carry=carry)
    z = rmsnorm(params["final_norm"], z, cfg.norm_eps)
    return lm_logits(params["embed"], z, cfg), aux


def loss_fn(params, batch: dict, cfg: ModelConfig, z_loss: float = 1e-4,
            carry: SolveCarry | None = None):
    """Next-token cross entropy (plus z-loss) of ``batch["tokens"]`` against
    ``batch["targets"]``.  Returns ``(loss, metrics)``; the metrics hold the
    loss terms and the DEQ solve's aux (``solve_carry`` among them when a
    carry is given)."""
    logits, aux = forward(params, batch, cfg, carry=carry)
    loss, metrics = cross_entropy(logits, batch["targets"], z_loss)
    metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


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


def prefix_seed_carry(cfg: ModelConfig, batch: int, seq: int,
                      snapshots: list, device=None) -> tuple[SolveCarry,
                                                            torch.Tensor]:
    """A PREFILL-shaped carry from per-row prefix-cache snapshots.

    ``snapshots``: one entry per row, ``None`` for a miss (the row stays
    cold, bit for bit a carryless prefill) or a host tuple ``(z, u, v,
    count)``: ``z (L, d)`` the cached prefix equilibrium, ``u``/``v (m, L,
    d)`` the donor's ring over the prefix positions (``None``/``count=0``
    for an iterate-only seed).  Suffix positions (``>= L``) are zero here;
    :func:`prefill` starts them at the live ``x_emb``, and the zero ring
    pairs act as the identity on them.  Built on the host and copied to
    ``device`` without a wait.  Returns ``(carry, prefix_len (B,) int32)``.

    ``count`` is the donor's as it stands, as :func:`prefix_gather_carry`
    takes it from the device store.  (The JAX package clamps it to ``m``
    here but not in its gather, so once a donor's ring has wrapped its two
    pipelines write the next pair to different ring slots and part bit for
    bit; the port's two do not.)
    """
    if len(snapshots) != batch:
        raise ValueError(f"{len(snapshots)} snapshots for batch {batch}")
    dev = resolve_device(device)
    tmpl = deq_solve_carry(cfg, batch, seq, "cpu")
    m = tmpl.memory
    z, u, v = tmpl.z, tmpl.lowrank.u, tmpl.lowrank.v
    count, warm = tmpl.lowrank.count, tmpl.warm
    plen = torch.zeros((batch,), dtype=torch.int32)
    for i, snap in enumerate(snapshots):
        if snap is None:
            continue
        sz, su, sv, sc = snap
        sz = torch.as_tensor(sz)
        length = sz.shape[0]
        if length > seq:
            raise ValueError(f"snapshot row {i}: prefix {length} > seq {seq}")
        warm[i] = True
        plen[i] = length
        z[i, :length] = sz.to(z.dtype)
        if su is not None and sv is not None and sc:
            su, sv = torch.as_tensor(su), torch.as_tensor(sv)
            if su.shape[0] != m:
                raise ValueError(
                    f"snapshot row {i}: ring memory {su.shape[0]} != {m}")
            u[:, i, :length] = su.to(u.dtype)
            v[:, i, :length] = sv.to(v.dtype)
            count[i] = int(sc)
    carry = SolveCarry(
        z=to_device(z, dev),
        lowrank=LowRank(
            alpha=torch.ones((), dtype=torch.float32, device=dev),
            u=to_device(u, dev), v=to_device(v, dev),
            count=to_device(count, dev)),
        warm=to_device(warm, dev),
        age=torch.zeros((batch,), dtype=torch.int32, device=dev))
    return carry, to_device(plen, dev)


def prefix_gather_carry(cfg: ModelConfig, batch: int, seq: int, arrays,
                        slot_ids: torch.Tensor,
                        prefix_len: torch.Tensor) -> tuple[SolveCarry,
                                                           torch.Tensor]:
    """A PREFILL-shaped carry gathered from the device prefix store's rows
    (:class:`~repro_torch.implicit.DevicePrefixStore`), on the device:
    ``arrays`` the store's ``(z, u, v, count)``, ``slot_ids (B,)`` the donor
    rows and ``prefix_len (B,)`` the matched lengths (0 = a miss: the row
    comes out cold, bit for bit a carryless prefill).  Positions past the
    matched length hold a donor's tail in the store and are zeroed here,
    as :func:`prefix_seed_carry` zero-pads."""
    z_s, u_s, v_s, c_s = arrays
    if u_s.shape[0] != cfg.deq.memory:
        raise ValueError(
            f"store ring memory {u_s.shape[0]} != cfg {cfg.deq.memory}")
    if z_s.shape[1] < seq:
        raise ValueError(f"store seq {z_s.shape[1]} < prompt seq {seq}")
    dev = z_s.device
    idx = slot_ids.to(device=dev, dtype=torch.long)
    pmask = (torch.arange(seq, dtype=torch.int32, device=dev)[None, :]
             < prefix_len[:, None])[..., None]
    z = torch.where(pmask, z_s.narrow(1, 0, seq).index_select(0, idx).to(
        act_dtype(cfg)), torch.zeros((), dtype=act_dtype(cfg), device=dev))
    zr = torch.zeros((), dtype=u_s.dtype, device=dev)
    u = torch.where(pmask[None], u_s.narrow(2, 0, seq).index_select(1, idx),
                    zr)
    v = torch.where(pmask[None], v_s.narrow(2, 0, seq).index_select(1, idx),
                    zr)
    warm = prefix_len > 0
    count = torch.where(warm, c_s.index_select(0, idx),
                        torch.zeros_like(prefix_len)).int()
    carry = SolveCarry(
        z=z,
        lowrank=LowRank(alpha=torch.ones((), dtype=torch.float32,
                                         device=dev), u=u, v=v, count=count),
        warm=warm,
        age=torch.zeros((batch,), dtype=torch.int32, device=dev))
    return carry, prefix_len


@torch.no_grad()
def prefill(params, batch: dict, cfg: ModelConfig, max_len: int, *,
            carry: SolveCarry | None = None,
            prefix_carry: SolveCarry | None = None,
            prefix_len: torch.Tensor | None = None,
            return_steps: bool = False, return_status: bool = False):
    """Encode a prompt ``batch["tokens"] (B, S)``; returns ``(logits (B, S,
    V), caches, lengths)``.

    ``carry`` (a decode-shaped ``deq_solve_carry(cfg, B, 1)``) is seeded
    with the last token's equilibrium and appended to the return, so the
    first decode step warm-starts.

    ``prefix_carry`` + ``prefix_len`` seed the prefill solve itself from a
    prefix-cache snapshot: warm rows start at ``where(pos < prefix_len,
    cached_z, x_emb)`` with the cached ring, cold rows are bit for bit a
    carryless prefill.  The return then gains ``(solve_carry, deq_steps)``:
    the converged prefill carry (to publish) and the solve's step count.

    ``return_steps`` appends the prefill solve's step count and
    ``return_status`` its per-row health codes (``core.solvers.STATUS_*``).
    """
    _check_family(cfg)
    dev = params_device(params)
    tokens = batch["tokens"].to(dev)
    x = embed_tokens(params["embed"], tokens, cfg)
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    caches = init_cache(cfg, b, max_len, dev)
    idx0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    solve_carry = None
    if prefix_carry is not None:
        if prefix_len is None:
            raise ValueError("prefix_carry requires prefix_len")
        # cached prefix positions start at the donor equilibrium, the live
        # suffix at the injection
        pmask = (pos < prefix_len[:, None])[..., None]
        solve_carry = dataclasses.replace(
            prefix_carry,
            z=torch.where(pmask, prefix_carry.z.to(x.dtype), x))
    z, caches, aux = _apply_deq(params, x, cfg, pos, caches, idx0,
                                carry=solve_carry)
    z_last = z[:, -1:, :]
    x = rmsnorm(params["final_norm"], z, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = (logits, caches, lengths)
    if carry is not None:
        out = out + (seed_carry(carry, z_last),)
    if prefix_carry is not None:
        out = out + (aux["solve_carry"], aux["deq_steps"])
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
