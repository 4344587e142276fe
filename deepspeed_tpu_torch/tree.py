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
