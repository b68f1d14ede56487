"""Trees of tensors: the nested dicts, lists and named tuples the port's
parameters and optimizer states are made of (JAX's pytrees, for the
shapes these modules use). Dict keys are visited in sorted order and named
tuples in field order, as `jax.tree_util` flattens them, so leaf lists and
key paths line up with the reference's."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """[(key path, leaf)] in flattening order; key paths are written as
    `jax.tree_util.keystr` writes them (`['a'][0].m['b']`)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [x for f in tree._fields
                for x in tree_leaves_with_path(getattr(tree, f),
                                               f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    keeping `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(tree: Any, leaves: list) -> Any:
    """A tree of `tree`'s structure holding `leaves` in flattening order."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = rebuild(t[k])
            return out
        if _is_namedtuple(t):
            return type(t)(*(rebuild(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(tree)
