"""Walkers of the port's nested trees (dicts of tensors, and NamedTuples
such as ``TrainState`` and ``AdamWState``), in ``jax.tree`` order: a
dict's keys sorted, a NamedTuple's fields in order. The optimizer, the
train loop and the checkpoints share them, so their leaf orders agree
with each other and with the reference's."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_items(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in leaf order, named as the reference's
    checkpoints name them: ``a/b`` for dict keys, ``.f`` for a
    NamedTuple's field."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in tree_items(tree[k], f"{path}/{k}" if path else str(k))]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields for pair in tree_items(getattr(tree, f), f"{path}/.{f}" if path else f".{f}")]
    return [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree):
    """``tree`` with each leaf replaced by ``fn(leaf)``; ``fn`` is called in
    leaf order, and each dict keeps its own key order."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f)) for f in tree._fields))
    return fn(tree)


def tree_unflatten(tree_like, leaves: List[Any]):
    """The structure of ``tree_like`` holding ``leaves`` (in leaf order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree_like)
