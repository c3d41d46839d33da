"""Parameter and state trees of the port: nested dicts, lists, tuples and
NamedTuples with tensors at the leaves.

Leaves come in the order ``jax.tree`` gives the reference's trees: dict
keys sorted, sequences and NamedTuple fields in order; ``None`` holds no
leaf.  So the port's optimizer and checkpoint walk a tree leaf for leaf as
the reference walks the same tree.
"""
from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten_with_paths(tree, path: str = "") -> Iterator[tuple[str, Any]]:
    """(dotted path, leaf) of every leaf, in ``jax.tree`` order."""
    def child(name) -> str:
        return f"{path}.{name}" if path else str(name)

    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_with_paths(tree[key], child(key))
    elif _is_namedtuple(tree):
        for name, sub in zip(tree._fields, tree):
            yield from flatten_with_paths(sub, child(name))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from flatten_with_paths(sub, child(i))
    else:
        yield path, tree


def leaves(tree) -> list:
    """Every leaf, in ``jax.tree`` order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in its leaf
    order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {key: build(t[key]) for key in sorted(t)}
            return {key: built[key] for key in t}
        if _is_namedtuple(t):
            return type(t)(*(build(sub) for sub in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(sub) for sub in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    columns = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])
