"""Nested dicts of tensors (a parameter tree, its gradients, an optimizer's
moments), walked in insertion order: the order in which
``chipbench/weights.py`` draws the leaves."""

from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def rebuild(tree, flat: list):
    """``tree``'s structure with its leaves taken in order from ``flat``
    (consumed)."""
    if isinstance(tree, dict):
        return {k: rebuild(v, flat) for k, v in tree.items()}
    return flat.pop(0)


def layer(tree, j: int):
    """Layer ``j`` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: layer(v, j) for k, v in tree.items()}
    return tree[j]


def leaf_names(tree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}.")]
    return [prefix[:-1]]
