"""Nested dicts and lists of leaves, named as the JAX package names its
pytrees' leaves: ``"/"``-joined dict keys (sorted, as ``jax.tree`` sorts
them) and list indices, e.g. ``"dense_layers/attn/wq"`` or
``"user_tower/0/w"``.  Checkpoints, the optimizers' state and the
weight converters use these names, so a tree written by one package is
read by the other."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the JAX package's leaf order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                  else str(key))
    return out


def tree_from_paths(items: Iterable[Tuple[str, Any]]):
    """The nested tree holding each ``(path, leaf)``; a level whose keys
    are all indices ``0 .. n-1`` becomes a list."""
    root: Dict[str, Any] = {}
    for path, leaf in items:
        node = root
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every leaf, the structure kept."""
    return tree_from_paths((p, fn(x)) for p, x in flatten_with_paths(tree))
