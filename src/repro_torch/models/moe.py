"""Fine-grained MoE (the DeepSeek family): shared experts plus routed top-k
experts, on one device.

The port of ``repro/models/moe.py``'s single-device branch (the
expert-parallel ``shard_map`` branch comes with the layout slice).  The
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

Nothing here reads the card from the host.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDecl, mlp, mlp_decl


_EXPERT_IN = ("expert", "embed", "expert_mlp")


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
               capacity: int):
    """The routed experts over ``x (T, d)``.  Returns ``(out (T, d), aux,
    zloss)``."""
    m = cfg.moe
    t, d = x.shape
    dt = x.dtype
    idx, gates, aux, zloss = _route(x, params["router"], cfg)
    cap = min(t, capacity)  # the reference's argsort(...)[:capacity]
    tab, slot = _expert_buckets(idx, m.num_experts, cap)
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


def moe_block(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """``x (B, S, d)`` -> ``(out, {"moe_aux", "moe_z"})``."""
    b, s, d = x.shape
    out, aux, zloss = _moe_local(x.reshape(b * s, d), params, cfg,
                                 _capacity(b * s, cfg.moe))
    out = out.reshape(b, s, d)
    if "shared" in params:
        out = out + mlp(params["shared"], x)
    return out, {"moe_aux": aux, "moe_z": zloss}
