"""Parameter trees: nested dicts of tensors, walked as the reference
walks its pytrees (dict keys in sorted order), with leaves named by
their ``/``-joined keys."""

from __future__ import annotations

from typing import Any

Tree = dict[str, Any]


def flatten(tree: Tree, prefix: str = "") -> dict[str, Any]:
    """``{"a/b": leaf, ...}`` in the reference's leaf order."""
    flat: dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            flat.update(flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def unflatten(flat: dict[str, Any]) -> Tree:
    """The nested dicts of a :func:`flatten` result."""
    tree: Tree = {}
    for key, leaf in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def leaves(tree: Tree) -> list:
    return list(flatten(tree).values())
