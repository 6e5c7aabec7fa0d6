"""Trees of tensors: nested dicts, tuples, lists and dataclasses, with
``None`` an empty subtree, walked in the order ``jax.tree_util`` walks the
reference's pytrees (dict keys sorted, sequences and dataclass fields in
order). The optimizer maps over such trees and the checkpoint manager
names and stores their leaves in that order, so a checkpoint of the
reference restores into the port leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


def _children(tree) -> list[tuple[str, Any]] | None:
    """(name, child) pairs of an inner node in walking order; None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _rebuild(tree, children: list):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, (tuple, list)):
        return type(tree)(children)
    return dataclasses.replace(
        tree, **{f.name: c for f, c in zip(dataclasses.fields(tree), children)})


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Every leaf with its path, keys joined by "/" (the reference
    checkpoint's leaf names)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out.extend(flatten_with_names(child, f"{prefix}/{name}" if prefix else name))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_names(tree)]


def unflatten(template, new_leaves) -> Any:
    """A tree shaped like ``template`` holding ``new_leaves`` in walking
    order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        kids = _children(t)
        if kids is None:
            return next(it)
        return _rebuild(t, [build(c) for _, c in kids])

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` of the leaves at one place in ``tree`` and each of ``rest``
    (trees of the same shape)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
