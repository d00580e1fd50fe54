"""LoRA fine-tuning (port of spatialvla_tpu/train/lora.py).

The reference wraps the torch model with peft (train/spatialvla_finetune.py:
262-302: r/alpha, init_lora_weights='gaussian', target presets 'linear' /
'linear+emb' / 'linear+emb+h', plus modules_to_save for the spatial
embedding table). As in the JAX package the factors live in a tree of their
own, keyed by the adapted leaf's '/'-joined path; each step builds the
effective weights from the base tree, detached (JAX's stop_gradient), so
autograd reaches only the factors and the 'saved' fully trainable tensors.
Stacked (L, in, out) leaves take stacked (L, in, r) / (L, r, out) factors.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import torch

from ..utils.tree import iter_leaves, map_with_paths

Params = Dict[str, Any]

# path-regex presets mirroring spatialvla_finetune.py:264-286
TARGET_PRESETS: Dict[str, List[str]] = {
    "linear": [
        r"lm/layers/attn/[qkvo]$",
        r"lm/layers/mlp/(gate|up|down)$",
        r"vision/layers/attn/[qkvo]/w$",
        r"vision/layers/mlp/fc[12]/w$",
        r"projector/w$",
        r"ego3d/fc[12]/w$",
    ],
    "linear+emb": [],  # filled below
    "linear+emb+h": [],
}
# 'emb' in the reference preset means the SPATIAL embedding table
# (spatialvla_finetune.py:271-286 adds 'spatial_embed_tokens' to
# target_modules), never the frozen LM token embedding
TARGET_PRESETS["linear+emb"] = TARGET_PRESETS["linear"] + [r"^spatial_embed$"]
TARGET_PRESETS["linear+emb+h"] = TARGET_PRESETS["linear+emb"] + [r"lm/lm_head$"]

# subtrees kept fully trainable alongside LoRA (peft modules_to_save)
DEFAULT_SAVED = (r"^spatial_embed$",)


def _matches(p: str, patterns) -> bool:
    return any(re.search(pat, p) for pat in patterns)


def lora_init(generator: torch.Generator, params: Params, *, target_patterns: List[str],
              rank: int = 32, dtype=torch.float32, exclude_patterns=DEFAULT_SAVED) -> Params:
    """The LoRA factor tree: for each matching weight of 2 or more dims
    (..., in, out), ``{'a': (..., in, r) N(0, 1) / r, 'b': (..., r, out)
    zeros}`` on the weight's device, drawn from ``generator`` in the tree's
    order.

    Paths matching ``exclude_patterns`` (the fully trainable 'saved'
    tensors, e.g. spatial_embed) never get factors: full training strictly
    dominates a LoRA adapter, and a factor over a saved leaf would detach it
    in lora_apply_tree."""
    factors = {}
    for p, leaf in iter_leaves(params):
        if not _matches(p, target_patterns) or leaf.dim() < 2:
            continue
        if exclude_patterns and _matches(p, exclude_patterns):
            continue
        a_shape = leaf.shape[:-1] + (rank,)
        b_shape = leaf.shape[:-2] + (rank, leaf.shape[-1])
        a = torch.randn(a_shape, generator=generator, device=generator.device)
        factors[p] = {
            # peft init_lora_weights='gaussian': A ~ N(0, 1/r), B zeros
            "a": (a / rank).to(device=leaf.device, dtype=dtype),
            "b": torch.zeros(b_shape, dtype=dtype, device=leaf.device),
        }
    return factors


def _delta(a, b, scale):
    return torch.einsum("...ir,...ro->...io", a, b) * scale


def lora_merge(params: Params, lora: Params, *, alpha: float = 32.0, rank: int = 32) -> Params:
    """Effective weights for the forward pass: each adapted leaf becomes
    base.detach() + (alpha / rank) * a @ b, so only the factors take
    gradients."""
    scale = alpha / rank

    def merge(p, leaf):
        if p in lora:
            delta = _delta(lora[p]["a"], lora[p]["b"], scale)
            return leaf.detach() + delta.to(leaf.dtype)
        return leaf

    return map_with_paths(merge, params)


def lora_apply_tree(params: Params, lora: Params, *, alpha: float = 32.0, rank: int = 32,
                    factored_prefixes: Tuple[str, ...] = ("lm/layers", "lm/lm_head")) -> Params:
    """Like lora_merge, but the big-matrix leaves become factor dicts
    ``{'w', 'a', 'b'}`` applied as x @ w + (x @ a) @ b (ops/quant.qmatmul),
    the memory-safe LoRA application: no second full weight copy for the LM.
    Leaves outside ``factored_prefixes`` (vision tower, projector, Ego3D) are
    merged as dense deltas."""
    scale = alpha / rank

    def apply(p, leaf):
        if p not in lora:
            return leaf
        a, b = lora[p]["a"], lora[p]["b"]
        if any(p.startswith(pref) for pref in factored_prefixes):
            return {"w": leaf.detach(), "a": (a * scale).to(a.dtype), "b": b}
        return leaf.detach() + _delta(a, b, scale).to(leaf.dtype)

    return map_with_paths(apply, params)


def lora_fold(params: Params, lora: Params, *, alpha: float = 32.0, rank: int = 32) -> Params:
    """Fold trained factors into the base weights for good (export): a tree
    of new tensors that take no gradient."""
    with torch.no_grad():
        merged = lora_merge(params, lora, alpha=alpha, rank=rank)
    return map_with_paths(lambda _, t: t.detach(), merged)


def extract_saved(params: Params, saved_patterns=DEFAULT_SAVED) -> Dict[str, Any]:
    """Flat {path: leaf} dict of the fully trainable 'saved' tensors (peft
    modules_to_save, e.g. the spatial embedding table); the leaves
    themselves, not copies."""
    return {p: leaf for p, leaf in iter_leaves(params) if _matches(p, saved_patterns)}


def insert_saved(params: Params, saved: Dict[str, Any]) -> Params:
    """The param tree with the saved tensors substituted back in."""
    return map_with_paths(lambda p, leaf: saved[p] if p in saved else leaf, params)
