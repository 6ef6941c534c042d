"""Trees of tensors: nested dicts, lists, tuples and named tuples (the
port's counterpart of ``jax.tree``).

``map_with_path`` and ``flatten_with_path`` name every leaf as
``jax.tree_util`` paths do in the reference's checkpointer: a dict entry by
its key, a list or tuple entry by its index, a named-tuple field as
``.<name>``; dict keys in sorted order.
So ``TrainState(params={"embed": ...}, ...)`` gives ``.params/embed/...``
in both packages.
"""

from __future__ import annotations

from typing import Any

__all__ = ["flatten_with_path", "leaves", "map_with_path", "tree_map"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples and named
    tuples such as ``KVCache``), with matching leaves of ``rest``; returns a
    tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, called in
    ``jax.tree_util``'s leaf order (dict keys sorted) with the reference
    checkpointer's path strings; returns a tree of the same structure."""
    def join(name):
        return f"{prefix}/{name}" if prefix else name

    if isinstance(tree, dict):
        done = {k: map_with_path(fn, tree[k], join(str(k)))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        names = ([f".{f}" for f in tree._fields] if hasattr(tree, "_fields")
                 else [str(i) for i in range(len(tree))])
        out = [map_with_path(fn, v, join(n)) for n, v in zip(names, tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(prefix, tree)


def flatten_with_path(tree) -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` in ``map_with_path``'s order."""
    out: list = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out
