"""Optimizers and learning-rate schedules as plain functions on tensors.

The port of ``repro/optim/optimizers.py``.  Not ``torch.optim``: the same
arithmetic as the JAX package, step for step, so both trainers produce the
same numbers.  Parameters, gradients and moments are nested dicts of
tensors; updates are functional (they return new tensors, which is what
lets a train step reject a non-finite update by keeping the old ones).

AdamW keeps f32 moments, b2 = 0.95, and decays only tensors with
``ndim >= 2``.  Schedules: warmup, then cosine (default), WSD
(warmup-stable-decay, MiniCPM's) or linear.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts (``rest`` shaped alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


class OptState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    mu: Tree
    nu: Tree


def adamw_init(params: Tree) -> OptState:
    leaf = tree_leaves(params)[0]
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                    mu=zeros, nu=tree_map(torch.clone, zeros))


def adamw_update(grads: Tree, state: OptState, params: Tree,
                 lr: torch.Tensor, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8,
                 weight_decay: float = 0.1) -> tuple[Tree, OptState]:
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t3: t3[i], out)  # noqa: E731
    return pick(0), OptState(step, pick(1), pick(2))


def sgdm_update(grads: Tree, state: OptState, params: Tree,
                lr: torch.Tensor, *, momentum: float = 0.9,
                weight_decay: float = 0.0) -> tuple[Tree, OptState]:
    def upd(p, g, m):
        gf = g.float()
        if p.ndim >= 2 and weight_decay:
            gf = gf + weight_decay * p.float()
        m2 = momentum * m + gf
        return (p.float() - lr * m2).to(p.dtype), m2

    out = tree_map(upd, params, grads, state.mu)
    pick = lambda i: tree_map(lambda t2: t2[i], out)  # noqa: E731
    return pick(0), OptState(state.step + 1, pick(1), state.nu)


def clip_by_global_norm(grads: Tree,
                        max_norm: float) -> tuple[Tree, torch.Tensor]:
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``; returns
    ``(clipped, norm)`` with the norm before clipping (f32)."""
    sq = sum((g.float() ** 2).sum() for g in tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def make_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step (int tensor) -> lr (f32 tensor)``: linear warmup over
    ``warmup_steps``, then the ``cfg.schedule`` body."""
    warm, total = cfg.warmup_steps, cfg.steps
    base, floor = cfg.lr, cfg.lr * cfg.min_lr_ratio

    def cosine(step):
        t = torch.clamp((step - warm) / max(total - warm, 1), 0.0, 1.0)
        return floor + 0.5 * (base - floor) * (1 + torch.cos(math.pi * t))

    def wsd(step):
        # stable at base, then linear decay over the last 10%
        decay_start = int(total * 0.9)
        t = torch.clamp((step - decay_start)
                        / max(total - decay_start, 1), 0.0, 1.0)
        return base * (1 - t) + floor * t

    def linear(step):
        t = torch.clamp((step - warm) / max(total - warm, 1), 0.0, 1.0)
        return base * (1 - t) + floor * t

    body = {"cosine": cosine, "wsd": wsd, "linear": linear}[cfg.schedule]

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm_lr = base * torch.clamp((step + 1) / max(warm, 1), max=1.0)
        return torch.where(step < warm, warm_lr, body(step))

    return sched
