"""Nested dict / list / tuple trees of tensors, in ``jax.tree_util`` order.

Dict keys are visited sorted (so ``attn/{wk,wo,wq,wv}`` comes before
``mlp``, ``norm1``, ``norm2``), lists, tuples and named tuples in order, and
``None`` is an empty subtree.  Keeping that order is what makes every
``FlatSpec`` offset of the port equal to the reference's.  A path names a
named tuple's field ``.field``, as ``jax.tree_util`` prints it, so
checkpoint keys equal the reference's too.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

LEAF = object()          # marks a leaf position inside a structure


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None)
        return [(f".{names[i]}" if names else i, x)
                for i, x in enumerate(tree)]
    return None


def structure(tree: Any) -> Any:
    """The tree with every leaf replaced by :data:`LEAF`."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return LEAF
    return _rebuild(tree, [structure(x) for _, x in kids])


def _rebuild(like, values):
    if isinstance(like, dict):
        return dict(zip(sorted(like), values))
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def leaves_with_paths(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in tree order; a path is the tuple of keys."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out.extend(leaves_with_paths(sub, prefix + (key,)))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(struct: Any, values: List[Any]) -> Any:
    """Inverse of :func:`leaves` for a :func:`structure`."""
    it = iter(values)

    def build(s):
        if s is None:
            return None
        if s is LEAF:
            return next(it)
        kids = _children(s)
        return _rebuild(s, [build(x) for _, x in kids])

    out = build(struct)
    if next(it, None) is not None:
        raise ValueError("more values than leaves in the structure")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    others = [leaves(r) for r in rest]
    vals = [fn(x, *(o[i] for o in others))
            for i, x in enumerate(leaves(tree))]
    return unflatten(structure(tree), vals)
