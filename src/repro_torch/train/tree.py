"""Nested containers of tensors (the port's stand-in for `jax.tree_util`).

A tree is a dict, a list, a tuple or a NamedTuple of trees, or a leaf (a
tensor, an array or a number); the walking is `torch.utils._pytree`'s.  A
leaf's path is the tuple of keys that reach it: dict keys and NamedTuple
field names as strings, list and tuple indices as ints, in the containers'
own order (what the decay mask and the checkpoint's leaf names read).
"""

from __future__ import annotations

from typing import Any, List, Tuple

from torch.utils import _pytree as pytree


def _key(entry):
    if isinstance(entry, pytree.MappingKey):
        return entry.key
    if isinstance(entry, pytree.SequenceKey):
        return entry.idx
    if isinstance(entry, pytree.GetAttrKey):
        return entry.name
    raise TypeError(f"unexpected tree key {entry!r}")


def leaves_with_path(tree) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in depth-first order."""
    flat, _ = pytree.tree_flatten_with_path(tree)
    return [(tuple(_key(e) for e in path), leaf) for path, leaf in flat]


def leaves(tree) -> List[Any]:
    return pytree.tree_leaves(tree)


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like `like` holding `new_leaves` in `leaves(like)`'s order."""
    return pytree.tree_unflatten(list(new_leaves), pytree.tree_structure(like))


tree_map = pytree.tree_map
