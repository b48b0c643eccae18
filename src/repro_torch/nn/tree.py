"""Minimal pytree helpers for the port's functional training state.

Trees are nested dicts (keys visited in sorted order, as jax flattens
them), lists, tuples and NamedTuples, with tensors (or other objects) as
leaves; None is an empty subtree, as in jax. The optimizer states, the
loss-scale state and the checkpoint layout all walk trees this way, so
leaf order and structure match the reference's."""
from __future__ import annotations

from typing import Any, Callable, List, Optional

Tree = Any


def is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_leaves(tree: Tree, is_leaf: Optional[Callable] = None
                ) -> List[Any]:
    """The leaves in order; `is_leaf(x)` true stops the walk at x (a
    tree of sharding specs keeps each spec tuple whole)."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]


def tree_unflatten(tree: Tree, leaves) -> Tree:
    """A tree of `tree`'s structure holding `leaves`, taken in
    `tree_leaves` order."""
    return tree_builder(tree)(iter(leaves))


def tree_builder(tree: Tree) -> Callable:
    """A function that makes a tree of `tree`'s structure from an
    iterator over its leaves, in `tree_leaves` order. The walk over the
    structure is done here, once, so building many trees of one
    structure costs little more than the containers themselves."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [tree_builder(tree[k]) for k in keys]
        return lambda it: {k: f(it) for k, f in zip(keys, subs)}
    if isinstance(tree, (list, tuple)):
        cls, subs = type(tree), [tree_builder(v) for v in tree]
        if is_namedtuple(tree):
            return lambda it: cls(*[f(it) for f in subs])
        return lambda it: cls([f(it) for f in subs])
    return next


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over corresponding leaves of `tree` and `rest` (same
    structure), rebuilt in `tree`'s structure; leaves are visited in
    `tree_leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
