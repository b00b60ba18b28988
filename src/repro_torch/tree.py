"""Parameter trees in the reference's leaf order.

A tree is nested dicts and lists (or tuples) whose leaves are tensors,
arrays or spec objects. The order is ``jax.tree_util.tree_flatten``'s:
dict keys sorted at every level, list items in order. A leaf's path is the
tuple of its keys and indices; :func:`keystr` joins it as the reference's
checkpoints name a leaf, ``"/".join(str(k) for k in key_path)`` of JAX's
key path: ``['blocks']/[0]/['ffn']/['w1']``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

__all__ = ["leaves_with_path", "leaves", "tree_map", "unflatten", "keystr"]


def _children(node):
    if isinstance(node, Mapping):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_path(tree, is_leaf: Callable[[Any], bool] | None = None, prefix: tuple = ()) -> list:
    """``(path, leaf)`` pairs in the reference's flatten order; ``None``
    holds no leaf."""
    if tree is None:
        return []
    kids = None if (is_leaf is not None and is_leaf(tree)) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(leaves_with_path(v, is_leaf, prefix + (k,)))
    return out


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def unflatten(like, values, is_leaf: Callable[[Any], bool] | None = None):
    """A tree of ``like``'s structure holding ``values`` in flatten order."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        kids = None if (is_leaf is not None and is_leaf(node)) else _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in kids}
        return type(node)(build(v) for _, v in kids)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] | None = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    others = [leaves(r) for r in rest]
    vals = [fn(leaf, *(o[i] for o in others)) for i, leaf in enumerate(leaves(tree, is_leaf))]
    return unflatten(tree, vals, is_leaf)


def keystr(path: tuple) -> str:
    """The reference's checkpoint key of a leaf path."""
    return "/".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)
