"""Nested-dict parameter trees, in the reference's pytree order.

JAX flattens a dict by its sorted keys; these helpers do the same, so a
tree's leaves (and ``robust.flatten_stacked``'s columns) come out in
``jax.flatten_util.ravel_pytree`` order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """Leaves of a nested dict / list / tuple, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    cols = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
