"""Nested dicts of tensors, the reference's pytrees (parameters, the
optimiser's and the trainer's state): leaves in ``jax.tree_util``'s
order (dict keys sorted) under their ``"a/b/c"`` paths, and a map over
several trees of one structure."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure (dicts nest)."""
    if isinstance(trees[0], Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def leaf_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in ``jax.tree_util`` order: dict keys sorted."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                  else str(k))
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _path, leaf in leaf_paths(tree)]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in leaf order."""
    it = iter(values)
    out = tree_map(lambda _leaf: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out

