"""Nested containers of tensors, flattened in the JAX package's leaf order.

The in-training modules (gradient reduction, AdamW) walk parameter trees:
nested dicts, lists and tuples whose leaves are tensors.  The order of the
leaves matters: the gradient codec concatenates them into one vector, so a
different order moves every block boundary and changes every code.  JAX
flattens a dict in SORTED key order, while ``torch.utils._pytree`` keeps
insertion order; this module follows JAX, so a tree flattens to the same
vector in both packages.  ``None`` is an empty subtree, as in JAX; any
other object (a namedtuple included) is a leaf.

:func:`flatten_with_path` also names each leaf by its path, as the JAX
package's checkpoint manager names it (``ft/checkpoint.py``'s ``_path_str``
over ``jax.tree_util.tree_flatten_with_path``): keys joined with ``/``,
sequence indices as numbers, namedtuple fields by name.  There, as in JAX,
a namedtuple is a node, not a leaf, and so is a codes dataclass with an
``ARRAYS`` tuple (``core.jitmode.ArrayState``, such as a compressed AdamW
moment, which the reference registers with ``register_dataclass``): its
array fields are its children, in ``ARRAYS`` order, and its other fields
travel in the structure.  The strings pick a leaf's checkpoint policy and
name its file, so a checkpoint crosses between the packages only if both
build the same strings.
"""
from __future__ import annotations

import dataclasses

from typing import Any, Callable, List, Tuple

#: a tree's structure: ("leaf",), ("none",), ("dict", keys, children),
#: ("list", children) or ("tuple", children)
TreeDef = Tuple


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """Leaves in JAX order (dict keys sorted) and the structure to rebuild."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _flatten(tree, leaves: List[Any]) -> TreeDef:
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys), tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_flatten(t, leaves) for t in tree))
    leaves.append(tree)
    return ("leaf",)


def flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``(path, leaf)`` pairs in JAX order and the structure to rebuild
    (with :func:`unflatten`).  Namedtuples are nodes here, their fields in
    declaration order."""
    out: List[Tuple[str, Any]] = []
    return out, _flatten_path(tree, (), out)


def _flatten_path(tree, path: Tuple[str, ...], out: List[Tuple[str, Any]]) -> TreeDef:
    if tree is None:
        return ("none",)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys), tuple(_flatten_path(tree[k], path + (str(k),), out) for k in keys))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = tuple(_flatten_path(v, path + (f,), out) for f, v in zip(tree._fields, tree))
        return ("namedtuple", type(tree), children)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) and getattr(tree, "ARRAYS", ()):
        arrays = tuple(tree.ARRAYS)
        meta = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree) if f.name not in arrays}
        children = tuple(_flatten_path(getattr(tree, f), path + (f,), out) for f in arrays)
        return ("arrays", type(tree), arrays, meta, children)
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_flatten_path(t, path + (str(i),), out) for i, t in enumerate(tree)))
    out.append(("/".join(path), tree))
    return ("leaf",)


def unflatten(treedef: TreeDef, leaves) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return out


_END = object()


def _unflatten(treedef: TreeDef, it) -> Any:
    kind = treedef[0]
    if kind == "leaf":
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree structure holds")
        return leaf
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(treedef[1], treedef[2])}
    if kind == "namedtuple":
        return treedef[1](*[_unflatten(c, it) for c in treedef[2]])
    if kind == "arrays":
        _, cls, arrays, meta, children = treedef
        return cls(**meta, **{f: _unflatten(c, it) for f, c in zip(arrays, children)})
    children = [_unflatten(c, it) for c in treedef[1]]
    return children if kind == "list" else tuple(children)


def flatten_up_to(treedef: TreeDef, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef`` (JAX's
    ``treedef.flatten_up_to``): a leaf position may hold any object, such
    as a compressed moment or a dict of its arrays."""
    out: List[Any] = []
    _up_to(treedef, tree, out)
    return out


def _up_to(treedef: TreeDef, tree, out: List[Any]) -> None:
    kind = treedef[0]
    if kind == "leaf":
        out.append(tree)
    elif kind == "dict":
        if not isinstance(tree, dict) or sorted(tree) != list(treedef[1]):
            raise ValueError(f"tree does not match the structure: expected keys {list(treedef[1])}")
        for k, c in zip(treedef[1], treedef[2]):
            _up_to(c, tree[k], out)
    elif kind in ("list", "tuple"):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(treedef[1]):
            raise ValueError(f"tree does not match the structure: expected a {kind} of {len(treedef[1])}")
        for c, t in zip(treedef[1], tree):
            _up_to(c, t, out)
    elif tree is not None:
        raise ValueError("tree does not match the structure: expected None")


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``, rebuilt in ``tree``'s structure."""
    leaves, treedef = flatten(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return unflatten(treedef, [fn(*args) for args in zip(leaves, *others)])
