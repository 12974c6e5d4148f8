"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, walked
in JAX's order (dict keys sorted) and named with JAX's key strings.

The reference's optimizers, train step and checkpoints work on pytrees
(`jax.tree.map`, `jax.tree.leaves`, `tree_flatten_with_path`); these
are the same walks for the port's trees, so a sum over leaves adds in
the reference's order and a checkpoint key reads `[1].mu['embed']` as
`jax.tree_util.keystr` writes it.  None is an empty node, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def leaves_with_path(tree: Any, prefix: str = ""
                     ) -> Iterator[Tuple[str, Any]]:
    """(key string, leaf) in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    """`jax.tree.leaves`: the leaves, dict keys sorted."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like: Any, values) -> Any:
    """A tree of `like`'s structure holding `values` in `leaves(like)`'s
    order (the inverse of `leaves`)."""
    return _build(like, iter(values))


def _build(t: Any, it) -> Any:
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle, and it would hold `values` (through
    # `it`) until the garbage collector runs
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if is_namedtuple(t):
        return type(t)(*(_build(v, it) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return None if t is None else next(it)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`jax.tree.map`: fn over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """tree_map with each leaf's key string as fn's first argument."""
    return _map_paths(lambda path, _, leaf: fn(path, leaf), tree, prefix, ())


def map_with_keys(fn: Callable[[tuple, Any], Any], tree: Any) -> Any:
    """tree_map with each leaf's path as fn's first argument: a tuple of
    dict keys, NamedTuple field names and sequence indices (what JAX's
    DictKey, GetAttrKey and SequenceKey entries hold)."""
    return _map_paths(lambda _, keys, leaf: fn(keys, leaf), tree, "", ())


def _map_paths(fn, tree, prefix: str, keys: tuple):
    """The walk of both: fn(key string, key tuple, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}[{k!r}]", keys + (k,))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(_map_paths(fn, v, f"{prefix}.{name}",
                                       keys + (name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{prefix}[{i}]", keys + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, keys, tree)


def structure(tree: Any) -> str:
    """The tree's structure as `str(jax.tree.structure(tree))` prints
    it, for the dicts, lists, tuples and NamedTuples above."""
    def node(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(node(v) for v in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "None" if t is None else "*"
    return f"PyTreeDef({node(tree)})"


__all__ = ["is_namedtuple", "leaves_with_path", "leaves", "unflatten",
           "tree_map", "map_with_path", "map_with_keys", "structure"]
