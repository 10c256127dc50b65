"""Nested trees of tensors, the port's stand-in for ``jax.tree``: dicts (in
insertion order), lists and tuples (NamedTuples kept) with anything else
at the leaves.  A leaf's path joins the keys, indices and field names on
the way to it with ``/`` (``layers/0/attn/wq``, ``opt/mu/embed/table``)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, depth first."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(tree_like, new_leaves) -> Any:
    """A tree of ``tree_like``'s structure holding ``new_leaves`` in
    :func:`flatten`'s order."""
    it = iter(new_leaves)
    out = tree_map(lambda _leaf: next(it), tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
