"""Solver-state packing.

The port of ``repro/implicit/pytree.py``.  The solvers work on one batched
``(B, *F)`` tensor; callers carry structured states (MDEQ's per-scale
feature maps, or a plain ``(B, S, d)`` activation for the DEQ-LM).

  * a **single-tensor** state passes through untouched (no reshape, no
    copy), so the ring contracts over the original feature axes;
  * a **multi-leaf** state (a tree of tuples, lists and dicts of ``(B,
    ...)`` tensors) is flattened to ``(B, D)``: the leaves in the JAX
    package's tree order (dict keys sorted), each reshaped to ``(B,
    prod(f_i))`` in the common dtype and concatenated.  ``unravel`` restores
    the structure, shapes and dtypes.  A leaf is flattened in its own
    element order, so an NHWC map packs exactly as the JAX package packs
    it.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch


def _leaves(tree) -> tuple[list, Callable[[list], Any]]:
    """Leaves in JAX tree order and the function that rebuilds the tree."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_leaves(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_leaves(v) for v in tree]
    else:
        return [tree], lambda new: new[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(new: list):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for p in parts for x in p[0]], rebuild


def ravel_state(tree) -> tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """Pack a state into one solver tensor.  Returns ``(flat, unravel)``;
    ``unravel(flat_like)`` restores the structure, shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        return tree, lambda z: z
    leaves, rebuild = _leaves(tree)
    if not leaves:
        raise ValueError("implicit state tree has no tensor leaves")
    if len(leaves) == 1:
        return leaves[0], lambda z: rebuild([z])
    bsz = leaves[0].shape[0]
    for leaf in leaves:
        if leaf.dim() < 1 or leaf.shape[0] != bsz:
            raise ValueError(
                "implicit state leaves must share a leading batch axis; got "
                f"shapes {[tuple(x.shape) for x in leaves]}")
    shapes = [tuple(x.shape[1:]) for x in leaves]
    dtypes = [x.dtype for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    common = dtypes[0]
    for dt in dtypes[1:]:
        common = torch.promote_types(common, dt)
    flat = torch.cat([x.to(common).reshape(bsz, -1) for x in leaves], dim=1)

    def unravel(z: torch.Tensor):
        outs, off = [], 0
        for s, n, dt in zip(shapes, sizes, dtypes):
            outs.append(z[:, off:off + n].reshape((z.shape[0],) + s).to(dt))
            off += n
        return rebuild(outs)

    return flat, unravel


def pack_state(leaves: list) -> tuple[torch.Tensor, Callable]:
    """The legacy helper of ``core.deq``: pack per-scale maps ``[(B, ...),
    ...]`` into ``(B, D)``; always flattens (a single leaf too) and unpacks
    to a list."""
    bsz = leaves[0].shape[0]
    shapes = [tuple(x.shape[1:]) for x in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([x.reshape(bsz, -1) for x in leaves], dim=1)

    def unpack(z: torch.Tensor) -> list:
        outs, off = [], 0
        for s, n in zip(shapes, sizes):
            outs.append(z[:, off:off + n].reshape((z.shape[0],) + s))
            off += n
        return outs

    return flat, unpack


def prepare_flat_problem(f, z0):
    """Shared preamble of ``implicit_fixed_point`` and ``batched_solve``:
    pack the state and wrap ``f(params, x, z)`` into its flat-state
    counterpart.  Returns ``(z0_flat, unravel, f_flat)``."""
    z0_flat, unravel = ravel_state(z0)

    def f_flat(p, xx, z_flat):
        return ravel_state(f(p, xx, unravel(z_flat)))[0]

    return z0_flat, unravel, f_flat
