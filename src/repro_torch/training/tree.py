"""Nested containers of tensors (the training state's trees), walked in
the reference's order: ``jax.tree_util`` flattens a dict in sorted key
order and a list or tuple by index; anything else is a leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_END = object()


def leaves_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in flattening order; a path is the tuple of dict
    keys and sequence indices from the root."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten_like(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(tree)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (trees of
    the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten_like(tree, [fn(leaf, *(o[i] for o in others))
                                 for i, leaf in enumerate(leaves(tree))])
