"""Parameter trees in the JAX package's leaf order.

The port keeps parameters, optimizer state and caches as plain nested
dicts, lists and named tuples of tensors.  ``flatten`` lists their
leaves in the order ``jax.tree.flatten`` gives: a dict's entries by
sorted key, a list's or tuple's (named tuples' fields included) in
order, ``None`` no leaf at all.  The checkpointer writes ``leaf_i`` in
that order and the train step differentiates the leaves in it.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _walk(tree: Any, fields: bool = False
          ) -> Tuple[List[Any], List[str], Any]:
    """(leaves, their paths, the structure) in JAX's order; ``fields``
    names a named tuple's entries by field, else by index."""
    out: List[Any] = []
    names: List[str] = []

    def walk(t, path):
        if t is None:
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k], path + (str(k),))
                                   for k in keys])
        if isinstance(t, (list, tuple)):
            ids = (getattr(t, "_fields", None) if fields else None) \
                or range(len(t))
            return (type(t), None, [walk(v, path + (str(i),))
                                    for i, v in zip(ids, t)])
        out.append(t)
        names.append("/".join(path))
        return "leaf"
    structure = walk(tree, ())
    return out, names, structure


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves in JAX's order, the structure ``unflatten`` rebuilds)."""
    out, _, structure = _walk(tree)
    return out, structure


def unflatten(structure: Any, leaves: List[Any]) -> Any:
    """The tree of ``structure`` (from ``flatten``) over ``leaves``."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == "leaf":
            return next(it)
        kind, keys, kids = s
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(keys, vals))
        if kind in (list, tuple):
            return kind(vals)
        return kind(*vals)                       # a named tuple
    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def paths(tree: Any, fields: bool = False) -> List[str]:
    """Each leaf's path of keys and indices joined by "/" (as
    ``"stack/blocks/sub1/moe/w_in"``), in ``flatten``'s order; with
    ``fields`` a named tuple's entries go by their field names (as
    ``"stack/blocks/sub0/k"``), as the JAX package's
    ``launch/shardings._path_str`` names them."""
    return _walk(tree, fields)[1]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, of the same structure), in the same structure."""
    flat, s = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("trees of different structure")
    return unflatten(s, [fn(*xs) for xs in zip(flat, *others)])
