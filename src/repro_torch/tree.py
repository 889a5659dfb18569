"""Nested-dict/list parameter trees in the reference's leaf order.

The reference's params, optimizer state and gradients are JAX pytrees;
JAX flattens a dict in sorted-key order and a list in index order.  The
port keeps the same trees as nested dicts and lists of tensors and walks
them in that order wherever the order is observable: the flattened
gradient that the ring exchanges (``ravel_pytree``'s layout), the global
norm's sum, and the checkpoint keys.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten_with_paths", "leaves", "tree_map", "unflatten"]


def flatten_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    """``[(path, leaf), ...]`` with ``path`` a tuple of dict keys and list
    indices, dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Any, new_leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (JAX's
    order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*ls) for ls in zip(*flat)])

