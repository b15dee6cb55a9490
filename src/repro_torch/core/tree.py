"""Nested dicts / lists / tuples of tensors — the port's parameter,
optimizer-state and batch trees — walked in the reference's leaf order.

JAX flattens a dict in sorted key order and a sequence in index order;
``leaves_with_paths`` does the same, so the i-th leaf here is the i-th
leaf of ``jax.tree.leaves`` of the same structure.  A path is the tuple of
keys from the root (a str per dict, an int per sequence index);
``path_key`` joins it as the reference's checkpoints do.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree: Any, prefix: Path = (),
                      is_leaf: Optional[Callable[[Any], bool]] = None
                      ) -> Iterator[Tuple[Path, Any]]:
    """``is_leaf(node)`` true stops the walk at ``node`` (as JAX's
    ``is_leaf``: a ``PartitionSpec`` is a tuple, but a leaf of a spec
    tree)."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,), is_leaf)
    else:
        yield prefix, tree


def leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree, (), is_leaf)]


def path_key(path: Path) -> str:
    """A dict key by its name, a sequence index as ``[i]``, joined with
    ``/`` (the reference's ``checkpoint._path_str``)."""
    return "/".join(f"[{p}]" if isinstance(p, int) else str(p)
                    for p in path)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), keeping the structure; ``is_leaf`` as in
    ``leaves_with_paths`` (tested on ``tree``'s nodes)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: Path = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping the
    structure (JAX's ``tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def unflatten(tree: Any, new_leaves: List[Any]) -> Any:
    """``tree``'s structure with ``new_leaves`` in ``leaves`` order."""
    it = iter(new_leaves)
    order = {path: next(it) for path, _ in leaves_with_paths(tree)}
    return _rebuild(tree, (), order)


def _rebuild(tree: Any, prefix: Path, order: dict) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, prefix + (k,), order) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, prefix + (i,), order)
                          for i, v in enumerate(tree))
    return order[prefix]
