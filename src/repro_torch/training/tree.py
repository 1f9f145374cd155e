"""Nested dicts and tuples of tensors (the reference's pytrees of parameters
and optimizer state) and the few maps the port needs over them.  Leaves are
taken in JAX's order: a dict's keys sorted, a tuple's items in order, so
that a sum over the leaves runs in the reference's order."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``,
    which have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, item, *(r[i] for r in rest))
                          for i, item in enumerate(tree))
    return fn(tree, *rest)
