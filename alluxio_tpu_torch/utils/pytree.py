"""Nested containers of tensors, flattened in ``jax.tree_util``'s order.

The port's counterpart of the few ``jax.tree_util`` calls the model and
its checkpoints need. A tree is a dict (children in sorted key order), a
list or tuple (children in order; a NamedTuple by its fields), ``None``
(no leaves, like JAX's empty subtree) or a leaf (anything else: a tensor,
a numpy array, a number). Flattening a parameter tree here and in JAX
gives the same leaves in the same order, which is what lets a checkpoint
that one package writes restore in the other.
"""

from __future__ import annotations

from typing import Any, List


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    out: List[Any] = []
    _collect(tree, out)
    return out


def _collect(tree, out: List[Any]) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            _collect(tree[key], out)
    elif isinstance(tree, (list, tuple)):
        for child in tree:
            _collect(child, out)
    else:
        out.append(tree)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


_END = object()


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        rebuilt = {key: _rebuild(tree[key], it) for key in sorted(tree)}
        return {key: rebuilt[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        children = [_rebuild(child, it) for child in tree]
        if isinstance(tree, list):
            return children
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*children)
        return type(tree)(children)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the tree has")
    return leaf
