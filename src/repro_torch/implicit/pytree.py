"""Solver-state packing.

The port of ``repro/implicit/pytree.py`` for single-leaf states: the
solvers work on one batched ``(B, *F)`` tensor, and a DEQ-LM state is
exactly that, so it passes through unflattened (the ring then contracts
over the original feature axes).  Multi-leaf states (MDEQ's per-scale
feature maps) are packed to ``(B, D)`` in the slice that ports MDEQ.
"""

from __future__ import annotations

from typing import Callable

import torch


def ravel_state(state) -> tuple[torch.Tensor, Callable]:
    """``(flat, unravel)`` for a single-tensor state (identity both ways)."""
    if not isinstance(state, torch.Tensor):
        raise TypeError(
            f"the ported solvers take a single (B, *F) tensor state; got "
            f"{type(state).__name__} (multi-leaf packing comes with MDEQ)")
    return state, lambda z: z


def prepare_flat_problem(f, z0):
    """Shared preamble of ``implicit_fixed_point`` and ``batched_solve``:
    pack the state and wrap ``f(params, x, z)`` into its flat-state
    counterpart.  Returns ``(z0_flat, unravel, f_flat)``."""
    z0_flat, unravel = ravel_state(z0)

    def f_flat(p, xx, z_flat):
        return ravel_state(f(p, xx, unravel(z_flat)))[0]

    return z0_flat, unravel, f_flat
