"""Optimizers and learning-rate schedules as plain functions on tensors.

The port of ``repro/optim/optimizers.py``.  Not ``torch.optim``: the same
arithmetic as the JAX package, step for step, so both trainers produce the
same numbers.  Parameters, gradients and moments are nested dicts of
tensors.  The updates write the new parameters and moments into the
state's own tensors, as the reference's step updates its donated state, so
a step never holds a second copy of them: a leaf is updated in flat chunks
of at most ``CHUNK`` elements (each temporary one chunk), and a rejected
step (``ok`` false) writes the old values back, bit for bit.

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


# the most elements an update temporary holds: xLSTM-1.3B's stacked mLSTM
# ``w_up`` (6 x 7 x 2048 x 8192) is 705 M elements, a 2.8 GB temporary in
# f32 if taken whole; a chunk of 2^24 makes it 64 MiB
CHUNK = 1 << 24


def _chunks(p: torch.Tensor, g: torch.Tensor, *moments: torch.Tensor):
    """Matching flat views of at most ``CHUNK`` elements of a parameter,
    its gradient and its moments.  The parameter and the moments are
    written through them, so they must be contiguous (a state's own
    tensors are: ``init_train_state`` and ``adamw_init`` make them so); a
    gradient that is not is copied."""
    if not (p.is_contiguous() and all(m.is_contiguous() for m in moments)):
        raise ValueError("an in-place update needs contiguous parameters "
                         "and moments")
    flat = [p.view(-1), g.reshape(-1), *(m.view(-1) for m in moments)]
    for i in range(0, p.numel(), CHUNK):
        yield [t[i:i + CHUNK] for t in flat]


def _write(ok: torch.Tensor | None, new: torch.Tensor,
           dst: torch.Tensor) -> None:
    """``dst = new``, or ``where(ok, new, dst)`` under a step's verdict."""
    if ok is None:
        dst.copy_(new)
    else:
        torch.where(ok, new, dst, out=dst)


def adamw_update(grads: Tree, state: OptState, params: Tree,
                 lr: torch.Tensor, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 ok: torch.Tensor | None = None) -> tuple[Tree, OptState]:
    """One AdamW step written into ``params`` and ``state``'s moments,
    which come back as the new trees.  With ``ok`` (a 0-d bool on the
    device) false every leaf keeps its old value; the returned step is
    ``state.step + 1`` either way."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        decay = p.ndim >= 2  # decoupled weight decay on matrices only
        for pc, gc, mc, vc in _chunks(p, g, m, v):
            gf = gc.float()
            m2 = b1 * mc + (1 - b1) * gf
            v2 = b2 * vc + (1 - b2) * gf * gf
            delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
            if decay:
                delta = delta + weight_decay * pc.float()
            _write(ok, (pc.float() - lr * delta).to(pc.dtype), pc)
            _write(ok, m2, mc)
            _write(ok, v2, vc)

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, OptState(step, state.mu, state.nu)


def sgdm_update(grads: Tree, state: OptState, params: Tree,
                lr: torch.Tensor, *, momentum: float = 0.9,
                weight_decay: float = 0.0,
                ok: torch.Tensor | None = None) -> tuple[Tree, OptState]:
    """One SGD-with-momentum step, in place as :func:`adamw_update`."""
    def upd(p, g, m):
        decay = p.ndim >= 2 and weight_decay
        for pc, gc, mc in _chunks(p, g, m):
            gf = gc.float()
            if decay:
                gf = gf + weight_decay * pc.float()
            m2 = momentum * mc + gf
            _write(ok, (pc.float() - lr * m2).to(pc.dtype), pc)
            _write(ok, m2, mc)

    tree_map(upd, params, grads, state.mu)
    return params, OptState(state.step + 1, state.mu, state.nu)


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
