"""Nested dicts of tensors as parameter trees (the flax variable layout).

Leaves are visited depth-first in insertion order, so two trees built the
same way flatten in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree shaped like `tree` holding `leaves` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
