"""Trees of tensors as the reference's pytrees flatten them.

The port keeps parameters and optimizer state as nested dicts and
dataclasses of tensors.  The reference flattens a dict in sorted key order
and a dataclass in field order, dropping ``None`` fields; the optimizer's
global norm, the checkpoint's leaf keys and its ``leaf_{i:05d}`` names all
follow that order, so these helpers do too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _is_node(tree: Any) -> bool:
    return isinstance(tree, dict) or (dataclasses.is_dataclass(tree)
                                      and not isinstance(tree, type))


def _children(tree: Any) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a node in flatten order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(``"a/b/c"`` path, leaf) pairs in the reference's flatten order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key, child in _children(tree):
        out += flatten_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, called in flatten order; the result keeps ``tree``'s
    structure (its dicts' key order included) and its ``None`` fields."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with ``leaves`` (in flatten order) as its leaves."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
