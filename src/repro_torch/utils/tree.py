"""Leaf paths over nested containers, named as ``jax.tree_util.keystr``
names them.

The pruning plans (``core.pruning.admm.PrunePlan``) match glob patterns
against leaf paths such as ``"['layers'][0]['attn']['w_q']['w']"``, and
checkpoints key their arrays by those paths, so the port walks its trees in
the JAX package's order and spells every path as ``keystr`` does:

* a dict: its keys in sorted order, each as ``[repr(key)]``;
* a named tuple or a dataclass: its fields in declared order, as ``.name``
  (a dataclass field whose metadata has ``static=True`` is not walked, as
  ``jax.tree_util.register_dataclass`` leaves meta fields out);
* a list or tuple: its items, as ``[i]``;
* ``None``: an empty subtree (no leaf);
* anything else: a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["leaves_with_path", "leaves", "map_with_path", "tree_map"]

Tree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _is_dataclass(node) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


def _data_fields(node) -> List[str]:
    return [f.name for f in dataclasses.fields(node) if not f.metadata.get("static")]


def _children(node) -> List[Tuple[str, Any]]:
    """``[(path_part, child)]`` of a container (``[]`` for ``None``)."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if _is_dataclass(node):
        return [(f".{f}", getattr(node, f)) for f in _data_fields(node)]
    raise TypeError(f"not a container: {type(node).__name__}")


def _is_container(node) -> bool:
    return node is None or isinstance(node, (dict, list, tuple)) or _is_dataclass(node)


def leaves_with_path(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Every leaf of ``tree`` with its path, in the JAX package's order."""
    if not _is_container(tree):
        yield prefix, tree
        return
    for part, child in _children(tree):
        yield from leaves_with_path(child, prefix + part)


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def _child(node, part: str, key):
    """The child of a ``rest`` tree at ``part`` / ``key`` (``None`` where the
    rest tree has ``None``: a mask tree's dense leaves)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return node[key]
    if part.startswith("."):
        return getattr(node, part[1:])
    return node[key]


def map_with_path(fn: Callable, tree: Tree, *rest: Tree, prefix: str = "") -> Tree:
    """``tree`` with every leaf replaced by ``fn(path, leaf, *rest_leaves)``;
    the ``rest`` trees mirror ``tree`` and may hold ``None`` where ``tree``
    holds a leaf or a subtree (``fn`` then gets ``None``).  ``None`` in
    ``tree`` stays ``None``.  Leaves are visited in :func:`leaves_with_path`'s
    order; a dict comes back with its keys sorted, as JAX rebuilds it."""
    if tree is None:
        return None
    if not _is_container(tree):
        return fn(prefix, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(_child(r, "[", k) for r in rest),
                                 prefix=f"{prefix}[{k!r}]")
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            map_with_path(fn, getattr(tree, f), *(_child(r, f".{f}", f) for r in rest),
                          prefix=f"{prefix}.{f}")
            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_path(fn, v, *(_child(r, "[", i) for r in rest), prefix=f"{prefix}[{i}]")
            for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        f: map_with_path(fn, getattr(tree, f), *(_child(r, f".{f}", f) for r in rest),
                         prefix=f"{prefix}.{f}")
        for f in _data_fields(tree)})


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """:func:`map_with_path` without the path."""
    return map_with_path(lambda _, leaf, *r: fn(leaf, *r), tree, *rest)
