"""Walks over the port's nested trees: dicts, lists, tuples and
NamedTuples with tensors (or arrays) at the leaves — params, optimizer
state, train state.  A leaf's path joins the keys, list indices and
NamedTuple field names on the way to it with ``/``
(``params/layers/0/attn/wq``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def _children(node):
    """``(key, child)`` pairs of an inner node; ``None`` for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, values):
    if isinstance(node, dict):
        return dict(zip(node, values))
    if hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def tree_map(fn: Callable, *trees):
    """``fn`` over the matching leaves of trees of one structure (dicts
    matched by key)."""
    t = trees[0]
    if _children(t) is None:
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    return _rebuild(t, [tree_map(fn, *xs) for xs in zip(*trees)])


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over every leaf, in the tree's structure."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_path(fn, v, _join(prefix, k))
                           for k, v in kids])


def items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs, depth first in the tree's own order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from items(v, _join(prefix, k))


def leaves(tree) -> List[Any]:
    """The leaves in the tree's own order (``None`` leaves dropped)."""
    return [x for _, x in items(tree) if x is not None]


def flatten(tree) -> Dict[str, Any]:
    """Flat ``path -> leaf`` (``None`` leaves dropped)."""
    return {p: x for p, x in items(tree) if x is not None}


def unflatten(template, arrays: Dict[str, Any]):
    """``template``'s structure with its leaves taken from ``arrays`` by
    path (``None`` leaves stay ``None``)."""
    def leaf(path, x):
        if x is None:
            return None
        if path not in arrays:
            raise KeyError(f"missing leaf {path}")
        return arrays[path]

    return map_with_path(leaf, template)


def nest(flat: Dict[str, Any]) -> Dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``: a flat tree's dicts
    without a template."""
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
