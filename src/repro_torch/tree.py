"""The port's trees: nested dicts and lists of tensors.

A parameter tree is the JAX package's tree with its ``stack`` unstacked
into a list of per-super-block dicts (``models/convert.py``); gradients
and the optimizer's moments have the same structure.  These helpers walk
such trees in one fixed order: dict keys sorted, list items in order.
"""
from __future__ import annotations


def flatten(node, prefix=()):
    """Yields (path, leaf) for every leaf; a path is a tuple of dict keys
    and list indices."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from flatten(node[key], prefix + (key,))
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            yield from flatten(child, prefix + (i,))
    else:
        yield prefix, node


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def map_tree(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, *children) for children in zip(tree, *rest)]
    return fn(tree, *rest)


def unflatten(tree, values):
    """A tree of ``tree``'s structure holding ``values`` (in
    ``flatten``'s order)."""
    it = iter(values)
    out = map_tree(lambda _: None, tree)
    for path, _ in flatten(tree):
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = next(it)
    return out
