"""Nested dict / list parameter trees: the flattening order of
``jax.tree_util`` (dict keys sorted, lists in order), so that a tree's
leaves line up with the JAX package's."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(template, leaves: list):
    """Rebuild ``template``'s nesting from ``leaves`` in tree_leaves
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
