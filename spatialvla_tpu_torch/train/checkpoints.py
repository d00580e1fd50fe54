"""The port's checkpoints of a parameter tree: one safetensors file.

The JAX package saves its trees with Orbax (spatialvla_tpu/train/
checkpoints.py:107 ``save_params``, :119 ``load_params``), which needs jax;
the port writes its own format instead, read and written by
``convert/safetensors_io`` (no ``safetensors`` package needed):

    <directory>/params.safetensors   every leaf under its path, keys joined
                                     with "/" ("lm/layers/attn/qkv/qt")
    <directory>/config.json          the SpatialVLAConfig, when given

Every dtype is kept as it is (int8 codes, uint8 int4 nibbles, f32 scales,
bf16 and f32 leaves), so a tree comes back bit for bit. The header's
``__metadata__`` holds the tree's nesting (dicts and lists) as JSON, so a
tree loads without a template. A JAX (Orbax) checkpoint directory is not
read here: ``load_params`` says so.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..convert.params import target_device
from ..convert.safetensors_io import SafetensorsFile, save_file

PARAMS_FILE = "params.safetensors"
FORMAT = "spatialvla_tpu_torch.tree"
FORMAT_VERSION = "1"


def _flatten(tree, prefix: str, leaves: Dict[str, torch.Tensor]):
    """The tree's nesting as JSON (a dict, a list, or a leaf's key), filling
    ``leaves``."""
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str) or "/" in k or not k:
                raise ValueError(f"tree key {k!r} under {prefix or 'the root'!r}: keys must be "
                                 "non-empty strings without '/'")
        return {k: _flatten(v, f"{prefix}{k}/", leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{prefix}{i}/", leaves) for i, v in enumerate(tree)]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"leaf {prefix[:-1]!r} is a {type(tree).__name__}, not a tensor")
    leaves[prefix[:-1]] = tree
    return prefix[:-1]


def save_params(directory: str, params, *, config_json: Optional[str] = None) -> int:
    """Write ``params`` (a nested dict / list of tensors on any device) and,
    when given, ``config.json``; returns the bytes of the tensor file."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    leaves: Dict[str, torch.Tensor] = {}
    spec = _flatten(params, "", leaves)
    metadata = {"format": FORMAT, "format_version": FORMAT_VERSION, "tree": json.dumps(spec)}
    nbytes = save_file(leaves, os.path.join(directory, PARAMS_FILE), metadata)
    if config_json is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            f.write(config_json)
    return nbytes


def load_params(directory: str, *, device="cuda", float_dtype=None) -> Dict[str, Any]:
    """The tree ``save_params`` wrote, each tensor moved to ``device`` once as
    it is read. ``float_dtype`` casts the floating leaves outside quantized
    ``{"qt", "scale"}`` leaves (None keeps every stored dtype)."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(path):
        if os.path.isdir(os.path.join(directory, "params")):
            raise ValueError(
                f"{directory} holds an Orbax checkpoint ('params/'), which the JAX package "
                "writes; the port reads its own format (params.safetensors). Export it from "
                "the JAX package as an HF checkpoint (convert.export_hf_checkpoint) and load "
                "that with SpatialVLAPolicy.from_hf_checkpoint")
        raise FileNotFoundError(f"{path} not found: not a checkpoint of the port")
    dev = target_device(device)
    f = SafetensorsFile(path)
    meta = f.metadata()
    if meta.get("format") != FORMAT or meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"{path}: format {meta.get('format')!r} version "
                         f"{meta.get('format_version')!r}, not {FORMAT!r} {FORMAT_VERSION}")

    def cast(tree, quantized=False):
        if isinstance(tree, dict):
            q = quantized or ("qt" in tree and "scale" in tree)
            return {k: cast(v, q) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, quantized) for v in tree]
        t = f.get_tensor(tree).to(dev)
        if float_dtype is not None and t.is_floating_point() and not quantized:
            t = t.to(float_dtype)
        return t.contiguous()

    return cast(json.loads(meta["tree"]))
