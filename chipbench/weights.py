"""Weights made from a configuration file and the run's seed.

The configuration's layout (``chipbench/layouts/<layout>.py``) gives every
leaf's name, shape, distribution and scale.  Every leaf is drawn on the
device by a generator of its own, seeded from ``--seed`` and the leaf's
index, so one leaf can be drawn again alone (the reference and the checks
need the first weights after the program has consumed its copy) and the
same seed always gives the same weights.
"""

from __future__ import annotations

import math

import torch

from chipbench import layouts

MASK63 = (1 << 63) - 1


def seed_of(seed: int, *parts: int) -> int:
    """A generator seed for ``parts`` under the run's ``seed`` (any whole
    number; the driver's exceed 32 bits)."""
    h = seed & MASK63
    for p in parts:
        h = (h * 6364136223846793005 + 1442695040888963407 + p) & MASK63
    return h


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


def leaf_names(cfg: dict) -> list[str]:
    return [s[0] for s in layouts.layout(cfg).leaf_specs(cfg)]


def make_leaf(cfg: dict, seed: int, name: str, device,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """Leaf ``name`` as drawn for ``seed``, in ``dtype`` (default: the
    configuration's)."""
    specs = layouts.layout(cfg).leaf_specs(cfg)
    idx = [s[0] for s in specs].index(name)
    _, shape, init, scale = specs[idx]
    dtype = dtype or dtype_of(cfg)
    if init == "ones":
        return torch.full(shape, scale, device=device).to(dtype)
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, idx))
    out = torch.empty(shape, device=device)
    if init == "normal":
        out.normal_(0.0, scale, generator=gen)
    else:
        std = 1.0 / math.sqrt(math.prod(shape[:-1]))
        torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=gen)
        out.mul_(scale)
    # the stored weights are the configuration's dtype; a float32 copy
    # for the reference holds those same values
    return out.to(dtype_of(cfg)).to(dtype)


def make_params(cfg: dict, seed: int, device,
                dtype: torch.dtype | None = None) -> dict:
    """Every leaf, as the nested dict the program takes."""
    tree: dict = {}
    for name in leaf_names(cfg):
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = make_leaf(cfg, seed, name, device, dtype)
    return tree
