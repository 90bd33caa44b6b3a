"""Minimal pytrees over tensors, in JAX's leaf order.

Parameters travel as a tensor or as (nested) dicts, lists and tuples
(named tuples too) of tensors.  Dict leaves are visited in sorted-key order, as
`jax.tree_util` visits them, so the flat-packed snapshot ring has the same
layout and offsets in both packages (the MLP packs ``b1, b2, b3, w1, w2,
w3``).
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_flatten", "tree_leaves", "tree_map"]


def tree_flatten(tree) -> tuple[list, Callable[[list], Any]]:
    """``(leaves, unflatten)``: ``unflatten(leaves)`` rebuilds the structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(ls) for ls, _ in parts]
    leaves = [leaf for ls, _ in parts for leaf in ls]

    def unflatten(flat):
        out, i = [], 0
        for (_, un), size in zip(parts, sizes):
            out.append(un(flat[i : i + size]))
            i += size
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)

    return leaves, unflatten


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(f, tree, *rest):
    """``f`` over corresponding leaves of ``tree`` and each of ``rest``."""
    leaves, unflatten = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    return unflatten([f(*xs) for xs in zip(leaves, *others)])
