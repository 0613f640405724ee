"""Fine-grained MoE (the DeepSeek family): shared experts plus routed top-k
experts, on one device or expert-parallel over a mesh.

The port of ``repro/models/moe.py``.  The
router's logits, softmax, top-k gates and the two aux losses (the
Switch-style load-balance loss and the router z-loss) are the reference's,
in f32.  Each expert keeps at most ``C = min(T, _capacity(T))`` of the
tokens routed to it, first come first served in token order; the rest are
dropped (their contribution is zero), exactly as the reference's
``_expert_bucket`` keeps them.

Dispatch is written in PyTorch's idiom instead of the reference's loop of
one bucket pass per expert (about 30 launches a layer, not ~1000):

  * one stable sort of the ``(T * k)`` (expert, token) pairs by expert, so
    that each expert's pairs stand in token order; a pair's rank within
    its expert is its sorted position minus the expert's first position;
  * the pairs of rank < C are scattered into an ``(E, C)`` table of token
    ids (an empty slot holds the id of an appended zero row);
  * the gathered ``(E, C, d)`` buffer goes through three ``torch.bmm``
    calls and SiLU (plain matrix products, which the reference leaves to
    XLA);
  * each token gathers its k outputs back and sums them weighted by its
    gates, in ascending expert order (the order in which the reference
    adds expert by expert), so the sum is deterministic;
  * the shared experts are one dense SwiGLU MLP of width
    ``num_shared * expert_d_ff``.

Under a running mesh whose "model" axis splits the experts (``ep > 1``),
the expert-parallel branch runs through ``local_map`` as the reference's
``shard_map`` does: each rank routes all of its DP shard's tokens, takes
the capacity from its local token count, runs its experts ``first =
rank_along("model") * n_local`` up to ``first + n_local`` over the shared
buckets, and the outputs come back as ``Partial`` sums over the expert
axis (aux and z-loss as ``Partial`` means).  With a capacity that drops
tokens, this is the reference's sharded arm, not its unsharded one.  At
``ep == 1`` the single-device branch runs on the whole batch (its
capacity from the global token count, as the reference's).

Nothing here reads the card from the host.  ``count_drops`` collects, for
a report, the pairs each routed call drops (device scalars).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDecl, mlp, mlp_decl
from repro_torch.parallel.sharding import (
    NULL_CTX,
    ShardCtx,
    placements,
    shard_map_compat,
)


_EXPERT_IN = ("expert", "embed", "expert_mlp")
# the dropped-pair counts of the routed calls inside ``count_drops``
_DROPS: list = []
_COUNTING: list = [False]


@contextlib.contextmanager
def count_drops():
    """Inside, each routed call appends its dropped (token, expert) pairs
    (a 0-d tensor on the device, this rank's tokens) to the yielded list."""
    _DROPS.clear()
    _COUNTING[0] = True
    try:
        yield _DROPS
    finally:
        _COUNTING[0] = False


def moe_decl(cfg: ModelConfig) -> dict:
    """The router ``(d, E)``, the routed experts' stacked SwiGLU weights and
    the shared experts' MLP.  (The reference declares the router f32 and its
    ``init_tree`` casts it to the model dtype with every other leaf; so does
    the port's ``init_params``.)"""
    d, m = cfg.d_model, cfg.moe
    eff = m.expert_d_ff
    decl = {
        "router": ParamDecl((d, m.num_experts), ("embed", None), "normal",
                            0.02),
        "wi_g": ParamDecl((m.num_experts, d, eff), _EXPERT_IN),
        "wi_u": ParamDecl((m.num_experts, d, eff), _EXPERT_IN),
        "wo": ParamDecl((m.num_experts, eff, d),
                        ("expert", "expert_mlp", "embed")),
    }
    if m.num_shared:
        decl["shared"] = mlp_decl(cfg, d_ff=m.num_shared * eff)
    return decl


def _route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """``x (T, d)`` -> (top-k expert ids ``(T, k)``, gates ``(T, k)`` in
    ``x.dtype``, load-balance loss, z-loss); the logits, softmax and losses
    in f32."""
    m = cfg.moe
    logits = x.float() @ router_w.float()
    scores = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(scores, m.top_k, dim=-1)
    if m.norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # each expert's share of the (token, k) pairs: a count of ones, exact
    # in any order of addition
    hits = torch.zeros(m.num_experts, dtype=torch.float32, device=x.device)
    hits.scatter_add_(0, idx.reshape(-1),
                      torch.ones(idx.numel(), device=x.device))
    density = hits / idx.numel()
    mean_prob = scores.mean(0)
    aux = m.num_experts * (density * mean_prob).sum()
    zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return idx, gates.to(x.dtype), aux, zloss


def _capacity(tokens: int, m) -> int:
    cap = int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, (cap + 7) // 8 * 8)


def _expert_buckets(idx: torch.Tensor, num_experts: int, capacity: int):
    """Every expert's bucket at once: the tokens each expert keeps, at most
    ``capacity``, first come first served in token order (the reference's
    ``_expert_bucket`` for each expert).

    Returns ``tab (E, C)``, the kept token ids in order (``T``, the id of
    an appended zero row, in an empty slot), and ``slot (T, k)``, each
    (token, k) pair's row in the flattened ``(E * C)`` buffer (``E * C``,
    a zero row, for a dropped pair)."""
    t, k = idx.shape
    dev = idx.device
    e_flat = idx.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices  # by expert, token order within
    e_sorted = e_flat[order]
    first = torch.searchsorted(e_sorted, torch.arange(num_experts,
                                                      device=dev))
    rank = torch.arange(t * k, device=dev) - first[e_sorted]
    dump = num_experts * capacity
    dest = torch.where(rank < capacity, e_sorted * capacity + rank,
                       torch.full_like(rank, dump))
    tab = torch.full((dump + 1,), t, dtype=torch.long, device=dev)
    tab[dest] = order // k  # repeated indices only at the dump slot
    slot = torch.empty_like(dest)
    slot[order] = dest
    return tab[:dump].view(num_experts, capacity), slot.view(t, k)


def _moe_local(x: torch.Tensor, params: dict, cfg: ModelConfig,
               capacity: int, first: int = 0):
    """The routed experts over ``x (T, d)``: the experts ``first`` up to
    ``first + n_local`` (``n_local`` the leading size of ``params``'
    expert stacks; all of them by default), every token routed over all
    ``num_experts``.  Returns ``(out (T, d), aux, zloss)``."""
    m = cfg.moe
    t, d = x.shape
    dt = x.dtype
    idx, gates, aux, zloss = _route(x, params["router"], cfg)
    cap = min(t, capacity)  # the reference's argsort(...)[:capacity]
    tab, slot = _expert_buckets(idx, m.num_experts, cap)
    if _COUNTING[0]:
        _DROPS.append((slot == m.num_experts * cap).sum())
    n_local = params["wi_g"].shape[0]
    if n_local != m.num_experts:  # this rank's experts; the rest dropped
        tab = tab[first:first + n_local]
        local = slot - first * cap
        slot = torch.where((local >= 0) & (local < n_local * cap), local,
                           torch.full_like(local, n_local * cap))
    zero = x.new_zeros((1, d))
    xg = torch.cat([x, zero])[tab]  # (E, C, d)
    h = (F.silu(torch.bmm(xg, params["wi_g"].to(dt)))
         * torch.bmm(xg, params["wi_u"].to(dt)))
    y = torch.bmm(h, params["wo"].to(dt)).reshape(-1, d)
    y = torch.cat([y, zero])
    # each token's k outputs, weighted and summed in ascending expert order
    _, by_expert = torch.sort(idx, dim=-1)
    slot = slot.gather(1, by_expert)
    gates = gates.gather(1, by_expert)
    out = y[slot[:, 0]] * gates[:, :1]
    for j in range(1, m.top_k):
        out = out + y[slot[:, j]] * gates[:, j:j + 1]
    return out, aux, zloss


_ROUTED = ("router", "wi_g", "wi_u", "wo")


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: ShardCtx = NULL_CTX) -> tuple[torch.Tensor, dict]:
    """``x (B, S, d)`` -> ``(out, {"moe_aux", "moe_z"})``."""
    b, s, d = x.shape
    ep = ctx.axis_size("expert_act") if ctx.running else 1
    if not ctx.running:
        out, aux, zloss = _moe_local(x.reshape(b * s, d), params, cfg,
                                     _capacity(b * s, cfg.moe))
        out = out.reshape(b, s, d)
    elif ep == 1:
        out, aux, zloss = _moe_whole(params, x, cfg, ctx)
    else:
        out, aux, zloss = _moe_expert_parallel(params, x, cfg, ctx, ep)
    if "shared" in params:
        out = out + mlp(params["shared"], x, ctx)
    out = ctx.constrain(out, ("batch", "seq_res", "embed_act"))
    return out, {"moe_aux": aux, "moe_z": zloss}


def _moe_whole(params, x, cfg, ctx):
    """``ep == 1`` on a mesh: the single-device branch over the whole
    batch on every rank (the capacity from the global token count)."""
    b, s, d = x.shape
    whole = (None, None, None)

    def body(xs, *ps):
        out, aux, zl = _moe_local(xs.reshape(b * s, d),
                                  dict(zip(_ROUTED, ps)), cfg,
                                  _capacity(b * s, cfg.moe))
        return out.reshape(b, s, d), aux, zl

    fn = shard_map_compat(
        body, ctx.device_mesh,
        in_specs=(whole,) + tuple((None,) * params[k].ndim
                                  for k in _ROUTED),
        out_specs=[whole, (), ()])
    out, aux, zloss = fn(x, *(params[k] for k in _ROUTED))
    return ctx.constrain(out, ("batch", "seq", "embed_act")), aux, zloss


def _moe_expert_parallel(params, x, cfg, ctx, ep):
    """The reference's shard_map branch: tokens split over the DP axes,
    experts over "expert_act"; outputs summed and the losses averaged over
    the expert axis (``Partial``)."""
    m = cfg.moe
    b, s, d = x.shape
    mesh = ctx.device_mesh
    n_local = m.num_experts // ep
    dp = math.prod(ctx.mesh_size(a) for a in ("pod", "data"))
    cap = _capacity((b * s) // max(1, dp), m)
    ep_axis = ctx.rules.physical("expert_act")
    first = ctx.axis_rank(ep_axis) * n_local
    x_pl = placements(ctx.spec(("batch", None, None)), mesh)
    e_pl = placements(ctx.spec(("expert_act", None, None)), mesh)
    rep = (Replicate(),) * mesh.ndim
    names = mesh.mesh_dim_names
    # per mesh dim: the expert axis sums (means) the experts' parts
    o_pl = tuple(Partial() if n == ep_axis else p
                 for n, p in zip(names, x_pl))
    l_pl = tuple(Partial("avg") if n == ep_axis else
                 (Partial("avg") if isinstance(p, Shard) else Replicate())
                 for n, p in zip(names, x_pl))

    def body(xs, router, wi_g, wi_u, wo):
        bl = xs.shape[0]
        out, aux, zl = _moe_local(
            xs.reshape(bl * s, d),
            {"router": router, "wi_g": wi_g, "wi_u": wi_u, "wo": wo}, cfg,
            cap, first)
        return out.reshape(bl, s, d), aux, zl

    # gradients: partial sums over the ranks that hold different tokens
    # (the DP axes) or different experts (the expert axis)
    split = [isinstance(p, Shard) or n == ep_axis
             for n, p in zip(names, x_pl)]
    xg = tuple(Partial() if n == ep_axis else p for n, p in zip(names, x_pl))
    rg = tuple(Partial() if sp else Replicate() for sp in split)
    eg = tuple(Partial() if isinstance(xp, Shard) else ep_
               for xp, ep_ in zip(x_pl, e_pl))
    fn = shard_map_compat(body, mesh,
                          in_specs=(x_pl, rep, e_pl, e_pl, e_pl),
                          out_specs=[o_pl, l_pl, l_pl],
                          in_grad_specs=(xg, rg, eg, eg, eg))
    return fn(x, *(params[k] for k in _ROUTED))
