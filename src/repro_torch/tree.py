"""Nested containers of tensors (the port's pytrees).

The port keeps params, gradients and optimizer moments as nested dicts
and lists of tensors (``params["blocks"]`` is a list of per-layer dicts).
:func:`tree_map` and :func:`leaves` walk them as ``jax.tree.map`` and
``jax.tree.leaves`` walk a JAX tree: dict keys in sorted order, lists and
tuples in order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in a tree of the same structure; leaves are
    visited in :func:`leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    return fn(tree, *rest)


def iter_leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from iter_leaves(t)
    else:
        yield tree


def leaves(tree: Any) -> List[Any]:
    """The leaves, dict keys sorted (``jax.tree.leaves``' order)."""
    return list(iter_leaves(tree))
