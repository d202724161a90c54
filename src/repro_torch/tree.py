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
    return _build(like, iter(new_leaves))


def _build(t, it):
    # a module-level function: a recursive closure over ``it`` would be a
    # reference cycle holding every new leaf until the garbage collector
    # ran, long after the tree itself was dropped
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    cols = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def size(tree) -> int:
    """Total element count of a tree's leaves (the flat dimension D)."""
    return sum(x.numel() for x in leaves(tree))
