"""Nested dicts of tensors, the port's stand-in for ``jax.tree``.

A dict's leaves are visited in sorted key order, as ``jax.tree`` visits
them, so a sum over leaves adds in the twin's order and a flat list of
leaves lines up with the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple


def leaves_with_paths(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path of keys, leaf)] in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out += leaves_with_paths(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def leaves(tree: Mapping[str, Any]) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Mapping[str, Any], *rest: Mapping[str, Any]):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in the same nesting."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, Mapping)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def unflatten(paths, values) -> dict:
    """The nested dict with ``values`` at ``paths``."""
    out: dict = {}
    for path, value in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out
