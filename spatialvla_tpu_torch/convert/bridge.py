"""Weight bridge between the JAX package's numpy pytrees and the port's
nested dicts of tensors.

Keys, stacked (L, ...) layer tensors and the (K, N) matmul layout stay as
they are, so one tree feeds both packages (the tests make weights with the
JAX initializers and hand the same numbers to both). Quantized leaves
``{"qt", "scale"}`` keep their dtypes and shapes (int8 codes, or uint8
packed int4 nibbles; f32 per-channel (N,) or grouped (N, G) scales).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def map_tree(fn: Callable[[torch.Tensor], Any], tree):
    """Apply fn to every tensor leaf of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def _to_tensor(a, device, dtype, keep_dtype: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 (what jax arrays export)
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy (jax exports read-only)
    if dtype is not None and t.is_floating_point() and not keep_dtype:
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree, device="cpu", dtype=None):
    """numpy (or jax) pytree -> nested dict of tensors on ``device``; float
    leaves are cast to ``dtype`` when given, except quantized leaves."""
    if isinstance(tree, dict):
        if "qt" in tree and "scale" in tree:
            return {k: _to_tensor(v, device, dtype, keep_dtype=True) for k, v in tree.items()}
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    return _to_tensor(tree, device, dtype, keep_dtype=False)


def to_numpy_tree(tree):
    """Nested dict of tensors -> numpy pytree (bf16 leaves become float32,
    which holds every bf16 value exactly)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(leaf, tree)
