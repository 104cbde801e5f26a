"""Trees of tensors: nested dicts, and NamedTuples such as ``AdamWState``.

The port's counterpart of the ``jax.tree_util`` calls the reference makes
on its parameter, moment and train-state trees.  Leaves come in the
dicts' insertion order.  A leaf's path is the reference's key string
(``jax.tree_util.keystr``): ``['blocks']['wq']`` for dict keys, ``.mu``
for a NamedTuple field, so a checkpoint's keys are the same in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_leaves", "tree_leaves_with_path", "tree_map",
           "tree_map_with_path"]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf, *leaves of
    rest)``; ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                               path=f"{path}.{name}")
                            for i, (name, v) in enumerate(zip(tree._fields, tree))))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf, *leaves of rest)``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves_with_path(tree: Any) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the order ``tree_map`` visits them."""
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
