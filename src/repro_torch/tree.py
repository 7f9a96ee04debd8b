"""Trees of tensors: the few ``jax.tree_util`` functions the training plane
uses, in JAX's order.

A tree is a nested ``dict``, ``list`` or ``tuple`` whose leaves are tensors
(or arrays); ``None`` is an empty subtree.  Leaves come in the order
``jax.tree_util.tree_flatten`` gives them: dict keys sorted, sequences in
order (``torch.utils._pytree`` keeps a dict's insertion order instead).
A leaf's name is ``jax.tree_util.keystr`` of its path (``"['a']"``,
``"['a']['b']"``, ``"[0]"``), so both packages name and order the leaves
of one tree alike.  A model's gradients are
``{name: p.grad for name, p in model.named_parameters()}``.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten_with_path", "leaves", "tree_map", "unflatten"]


def _children(node) -> list[tuple[str, Any]] | None:
    """``(key string, child)`` of a container node in JAX's order, or
    ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_path(tree: Any, is_leaf: Callable | None = None) -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` of every leaf, in JAX's order; ``is_leaf`` marks
    containers to keep whole, as ``jax.tree_util``'s does."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [("", tree)]
    return [(key + sub, leaf) for key, child in kids for sub, leaf in flatten_with_path(child, is_leaf)]


def leaves(tree: Any) -> list:
    """The leaves of ``tree``, in JAX's order (``jax.tree.leaves``)."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf of ``tree`` and the leaves at the same place in
    ``rest``, in a tree of ``tree``'s structure (``jax.tree.map``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def unflatten(tree: Any, new_leaves) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` in JAX's leaf
    order (``jax.tree.unflatten(jax.tree.structure(tree), new_leaves)``)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            out = [build(c) for c in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)

    return build(tree)
