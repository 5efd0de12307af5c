"""Leaves of an optimizer's slot state, named as ``jax.tree_util`` names
them.

A slot state is a tree of tuples, lists, dicts and NamedTuples over
tensors (``()`` for the fused optimizers, whose state lives in the value
rows). Checkpoints store each leaf under the key path ``jax.tree_util``
gives it (``[0]``, ``['acc']``, ``.acc``; dict keys in sorted order, None
an empty subtree), so saves stay interchangeable with the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def map_leaves(fn: Callable[[str, Any], Any], tree, _path: str = ""):
    """``tree`` rebuilt with ``fn(path, leaf)`` in place of every leaf."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_leaves(fn, v, f"{_path}.{k}")
                            for k, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, v, f"{_path}[{i}]")
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], f"{_path}[{k!r}]")
                for k in sorted(tree)}
    return fn(_path, tree)


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in flatten order."""
    out: List[Tuple[str, Any]] = []
    map_leaves(lambda p, leaf: out.append((p, leaf)), tree)
    return out
