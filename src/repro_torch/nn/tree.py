"""Minimal pytree helpers for the port's functional training state.

Trees are nested dicts (keys visited in sorted order, as jax flattens
them), lists, tuples and NamedTuples, with tensors (or other objects) as
leaves; None is an empty subtree, as in jax. The optimizer states, the
loss-scale state and the checkpoint layout all walk trees this way, so
leaf order and structure match the reference's."""
from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_leaves(tree: Tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


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
