"""Nested-dict trees of tensors in JAX's leaf order.

The port's parameter and optimizer trees are nested dicts, as the
reference's pytrees are.  JAX flattens a dict by its sorted keys, level by
level; these helpers walk the same order, so a sum over leaves (the global
gradient norm) adds in the reference's order, and a checkpoint's paths
(``params/layers/attn/wq``) are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def items(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs, the path a tuple of keys, in JAX's order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in items(tree)]


def map_(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {key: map_(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def unflatten(tree: Any, new_leaves) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` in
    :func:`items` order."""
    it = iter(new_leaves)
    out = map_(lambda _: None, tree)
    for path, _ in items(tree):
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = next(it)
    return out
