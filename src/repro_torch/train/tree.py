"""Nested state trees of the training runtime: dicts (parameters and
moments keyed by name), named tuples (``AdamWState``), lists and tuples,
with tensors, arrays or numbers at the leaves.

Leaves are visited in insertion order. A leaf's path is written as the
JAX package writes it (``jax.tree_util.keystr``): ``['params']['embed.
tok']`` for dict keys, ``.mu`` for named-tuple fields, ``[0]`` for
sequence positions.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of ``tree``."""
    if isinstance(tree, Mapping):
        for key, sub in tree.items():
            yield from leaves_with_path(sub, f"{path}[{key!r}]")
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from leaves_with_path(getattr(tree, field),
                                        f"{path}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_path(sub, f"{path}[{i}]")
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree_like: Any, new_leaves: Iterator[Any]) -> Any:
    """A tree shaped as ``tree_like`` holding ``new_leaves`` in leaf
    order."""
    if isinstance(tree_like, Mapping):
        return {key: unflatten(sub, new_leaves)
                for key, sub in tree_like.items()}
    if _is_namedtuple(tree_like):
        return type(tree_like)(*(unflatten(getattr(tree_like, f), new_leaves)
                                 for f in tree_like._fields))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(unflatten(sub, new_leaves)
                               for sub in tree_like)
    return next(new_leaves)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure)."""
    columns = [leaves(tree)] + [leaves(t) for t in rest]
    return unflatten(tree, iter([fn(*xs) for xs in zip(*columns,
                                                        strict=True)]))
