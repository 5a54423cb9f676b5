"""Nested containers of tensors (the port's pytrees): dicts, lists, tuples
and named tuples, whose leaves are tensors or other objects.

The port's parameters are nested dicts (``params["layers"][i]["attn"]
["wq"]``), its optimizer state a named tuple of such trees. These helpers
walk them in one fixed order (dict keys sorted, as ``jax.tree`` flattens
them) and name each leaf by its path, ``layers/3/attn/wq``, which is how a
checkpoint keys it.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the tree's fixed order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out.extend(flatten_with_paths(child, f"{prefix}/{name}" if prefix else name))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(template, values) -> Any:
    """A tree shaped as ``template`` holding ``values`` (an iterable, in the
    order of ``leaves(template)``)."""
    it = iter(values)

    def build(t):
        if _is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}            # keep the template's key order
        kids = [build(c) for c in t]
        return type(t)(*kids) if _is_namedtuple(t) else type(t)(kids)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def map_(fn: Callable, tree) -> Any:
    """``fn`` applied to every leaf of ``tree``, in a tree of its shape."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
