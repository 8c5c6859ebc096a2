"""Nested dicts of tensors (parameter, gradient and optimizer trees),
walked in sorted key order at every level: the reference's pytree order,
so a leaf's path (``params/blocks/attn/wq``) and its place in
:func:`leaves` match the reference's."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple

__all__ = ["paths", "leaves", "unflatten", "tree_map"]


def paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, the keys joined by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def leaves(tree) -> List[Any]:
    """The leaves of a nested dict, in :func:`paths` order."""
    return [t for _, t in paths(tree)]


def unflatten(like, flat: Iterable):
    """``flat`` (in :func:`leaves` order) as a tree shaped as ``like``."""
    it = iter(flat)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return next(it)
    return build(like)


def tree_map(tree, fn: Callable):
    """``fn`` on every leaf of a nested dict, its keys in their order."""
    if isinstance(tree, dict):
        return {k: tree_map(t, fn) for k, t in tree.items()}
    return fn(tree)
