"""Nested dicts of tensors (the port's pytrees) walked as JAX walks them.

``jax.tree`` orders a dict's leaves by sorted key, and
``jax.tree_util.tree_flatten_with_path`` names a leaf by its keys joined
with ``/``. The optimizer sums the gradient norm and the checkpoint store
writes its manifest in that order, so the port's sums and files follow
the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_paths(tree: dict, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, keys sorted, paths joined by ``/``."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves_with_paths(v, f"{prefix}{k}/")
        else:
            yield prefix + str(k), v


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the like-shaped ``rest``."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def unflatten(flat: dict, sep: str = "/") -> dict:
    """``{"a/b": leaf}`` -> ``{"a": {"b": leaf}}`` (``sep`` joins keys)."""
    tree: dict = {}
    for path, leaf in flat.items():
        *head, last = path.split(sep)
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree
