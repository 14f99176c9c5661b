"""Nested states as trees: tuples, lists and dicts of leaves (tensors,
numpy values, Python numbers), in JAX's pytree order.

A state of the port has the JAX state's structure, so the leaves come in
the same order here as ``jax.tree_util.tree_leaves`` gives them there:
dicts by sorted key, ``None`` and ``()`` with no leaves.  The key paths
are JAX's ``keystr`` strings ("[0][1]", "['ops']['lpf']"), which the
checkpoint files record.
"""

from __future__ import annotations

__all__ = ["leaves_with_paths", "leaves", "unflatten_like", "tree_map"]


def _children(tree):
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", t) for i, t in enumerate(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return None


def leaves_with_paths(tree, prefix: str = ""):
    """``[(path, leaf), ...]`` in JAX's leaf order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, t in kids:
        out += leaves_with_paths(t, prefix + key)
    return out


def leaves(tree):
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten_like(like, values):
    """A tree of ``like``'s structure holding ``values`` (one per leaf of
    ``like``, in leaf order)."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return type(t)(build(c) for c in t)
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *ts) for ts in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
