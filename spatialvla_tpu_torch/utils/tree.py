"""Tree path utilities over nested dicts and lists (port of
spatialvla_tpu/utils/tree.py, which walks JAX pytrees).

A leaf's path is its keys (dict keys or list indices) joined with "/", as
JAX's key paths print: ``"lm/layers/attn/q"``. ``None`` is an empty subtree,
as in JAX: it has no leaves and maps to itself. One walker serves the
optimizer, the freezing policy, LoRA and the parameter summaries.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def children(tree):
    """(key, subtree) pairs of a dict, list or tuple; None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def path_str(path) -> str:
    """A sequence of keys -> the '/'-joined path string."""
    return "/".join(str(k) for k in path)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def iter_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the tree's order (dict insertion order)."""
    if tree is None:
        return
    kids = children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from iter_leaves(v, _join(prefix, k))


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    return list(iter_leaves(tree))


def map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The tree with every leaf replaced by ``fn(path, leaf)``; dicts, lists
    and tuples keep their type and order."""
    if tree is None:
        return None
    kids = children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [map_with_paths(fn, v, _join(prefix, k)) for k, v in kids]
    return dict(zip(tree.keys(), out)) if isinstance(tree, dict) else type(tree)(out)


def count_params(tree) -> int:
    return sum(int(x.numel()) for _, x in iter_leaves(tree))


def param_summary(tree, max_depth: int = 2) -> Dict[str, int]:
    """Parameter counts grouped by path prefix (the reference's
    trainable-parameter dump, spatialvla_pretrain.py:352-354)."""
    out: Dict[str, int] = {}
    for p, leaf in iter_leaves(tree):
        key = "/".join(p.split("/")[:max_depth])
        out[key] = out.get(key, 0) + int(leaf.numel())
    return out
