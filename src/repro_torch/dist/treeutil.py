"""Walkers for value trees paired with logical-axes trees (a copy of
``repro/dist/treeutil.py``).

An *axes tree* mirrors a value tree's container structure (dicts, tuples,
lists) but its leaves are tuples of logical axis names, one ``str | None``
per tensor dimension, ``()`` for scalars.  A generic tree map would recurse
into the axes tuples, so these walkers treat a tuple whose elements are all
``str | None`` as a leaf.

Used by ``repro_torch.serve.sharding`` (a placement per parameter and cache
leaf).
"""
from __future__ import annotations

from typing import Any, Callable


def is_axes_leaf(x: Any) -> bool:
    """True for a tuple of logical axis names (incl. () for scalars)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def map_axes(fn: Callable[[tuple], Any], axes_tree: Any) -> Any:
    """Map ``fn`` over every axes leaf of an axes tree."""
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v) for k, v in axes_tree.items()}
    if is_axes_leaf(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, (tuple, list)):
        if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*(map_axes(fn, v) for v in axes_tree))
        return type(axes_tree)(map_axes(fn, v) for v in axes_tree)
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def map_zip_with_axes(fn: Callable[..., Any], value_tree: Any,
                      other_tree: Any, axes_tree: Any) -> Any:
    """Like ``map_with_axes`` but zips a second value tree:
    ``fn(value_leaf, other_leaf, axes_leaf)``.  Used by the serve subsystem
    to pair a paged cache with a prefill cache plus their axes."""
    if isinstance(value_tree, dict):
        return {k: map_zip_with_axes(fn, v, other_tree[k], axes_tree[k])
                for k, v in value_tree.items()}
    if isinstance(value_tree, (tuple, list)):
        if isinstance(value_tree, tuple) and hasattr(value_tree, "_fields"):
            return type(value_tree)(*(map_zip_with_axes(fn, v, o, a)
                                      for v, o, a in zip(value_tree,
                                                         other_tree,
                                                         axes_tree)))
        return type(value_tree)(map_zip_with_axes(fn, v, o, a)
                                for v, o, a in zip(value_tree, other_tree,
                                                   axes_tree))
    return fn(value_tree, other_tree, axes_tree)


def map_with_axes(fn: Callable[[Any, Any], Any], value_tree: Any,
                  axes_tree: Any) -> Any:
    """Map ``fn(value_leaf, axes_leaf)`` over a value tree, walking the
    *value* tree's containers and indexing the axes tree in parallel (so an
    empty container and a scalar's ``()`` axes never collide)."""
    if isinstance(value_tree, dict):
        return {k: map_with_axes(fn, v, axes_tree[k])
                for k, v in value_tree.items()}
    if isinstance(value_tree, (tuple, list)):
        if isinstance(value_tree, tuple) and hasattr(value_tree, "_fields"):
            return type(value_tree)(*(map_with_axes(fn, v, a)
                                      for v, a in zip(value_tree, axes_tree)))
        return type(value_tree)(map_with_axes(fn, v, a)
                                for v, a in zip(value_tree, axes_tree))
    return fn(value_tree, axes_tree)
