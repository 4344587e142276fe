"""Nested dicts of tensors: the port's stand-in for the JAX package's
pytrees (parameters, gradients, optimizer moments, batches). Leaves are
visited in sorted key order everywhere, so two trees of one structure line
up leaf for leaf."""

from typing import Dict, Iterable, Iterator


def tree_leaves(tree) -> Iterator:
    """Leaves of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure, in the
    order of :func:`tree_leaves`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like: Dict, leaves: Iterable) -> Dict:
    """A tree of ``like``'s structure holding ``leaves``, given in the
    order of :func:`tree_leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_paths(tree, prefix: str = "") -> Iterator:
    """``(path, leaf)`` of a nested dict in the order of
    :func:`tree_leaves`, the path its keys joined by ``/``."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_paths(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def tree_from_paths(pairs: Iterable) -> Dict:
    """The nested dict of ``(path, leaf)`` pairs (the inverse of
    :func:`tree_paths`)."""
    tree: Dict = {}
    for path, leaf in pairs:
        *head, last = path.split("/")
        node = tree
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree
