"""TFDS on-disk metadata, tfds-free.

An RLDS/TFDS dataset directory contains `features.json` (schema),
`dataset_info.json` (splits, shard lengths), and TFRecord shards named
`<name>-<split>.tfrecord-XXXXX-of-NNNNN`. Episodes are single tf.Examples
whose nested feature keys are '/'-joined and whose per-step tensors are
flattened across the step (time) dimension.

This module parses the schema and decodes raw parsed Examples into numpy
episode dicts — replacing `tfds.builder_from_directory` +
`as_dataset` (used by the reference via dlimp, data/rlds.py:194).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

DTYPES = {
    "float32": np.float32, "float64": np.float64, "float16": np.float16,
    "int64": np.int64, "int32": np.int32, "int8": np.int8, "uint8": np.uint8,
    "uint16": np.uint16, "bool": np.bool_, "string": np.bytes_,
}


@dataclasses.dataclass
class FeatureSpec:
    key: str                       # '/'-joined flat key
    dtype: str                     # tfds dtype name or 'string'
    shape: Tuple[int, ...]         # per-element shape (no time dim)
    encoding: Optional[str] = None # 'jpeg' | 'png' | None
    sequence: bool = False         # lives under steps/ (leading time dim)

    @property
    def is_image(self) -> bool:
        return self.encoding is not None


def _walk(node: Dict[str, Any], prefix: str, sequence: bool, out: Dict[str, FeatureSpec]):
    cls = node.get("pythonClassName", "")
    if cls.endswith("FeaturesDict"):
        for name, sub in node["featuresDict"]["features"].items():
            key = f"{prefix}{name}" if not prefix else f"{prefix}/{name}"
            _walk(sub, key, sequence, out)
    elif cls.endswith("dataset_feature.Dataset") or "sequence" in node:
        inner = node.get("sequence", node.get("dataset", {})).get("feature", {})
        _walk(inner, prefix, True, out)
    elif cls.endswith("Image") or "image" in node:
        img = node.get("image", {})
        dims = [int(d) for d in img.get("shape", {}).get("dimensions", [])]
        out[prefix] = FeatureSpec(
            prefix, img.get("dtype", "uint8"), tuple(dims),
            encoding=img.get("encodingFormat", "png"), sequence=sequence,
        )
    elif cls.endswith("Text") or "text" in node:
        out[prefix] = FeatureSpec(prefix, "string", (), sequence=sequence)
    elif cls.endswith("Scalar") or "scalar" in node:
        sc = node.get("scalar", {})
        out[prefix] = FeatureSpec(prefix, sc.get("dtype", "float32"), (), sequence=sequence)
    elif cls.endswith("Tensor") or "tensor" in node:
        t = node.get("tensor", {})
        dims = [int(d) for d in t.get("shape", {}).get("dimensions", [])]
        out[prefix] = FeatureSpec(
            prefix, t.get("dtype", "float32"), tuple(dims), sequence=sequence
        )
    # ClassLabel and others: treat as int64 scalar
    elif cls.endswith("ClassLabel") or "classLabel" in node:
        out[prefix] = FeatureSpec(prefix, "int64", (), sequence=sequence)


def load_schema(dataset_dir: str) -> Dict[str, FeatureSpec]:
    with open(os.path.join(dataset_dir, "features.json")) as f:
        root = json.load(f)
    out: Dict[str, FeatureSpec] = {}
    _walk(root, "", False, out)
    return out


def list_shards(dataset_dir: str, split: str = "train") -> List[str]:
    def match(fn: str) -> bool:
        if ".tfrecord" not in fn:
            return False
        return f"-{split}.tfrecord" in fn or fn.startswith(f"{split}.tfrecord")

    names = sorted(fn for fn in os.listdir(dataset_dir) if match(fn))
    return [os.path.join(dataset_dir, fn) for fn in names]


def load_dataset_info(dataset_dir: str) -> Dict[str, Any]:
    path = os.path.join(dataset_dir, "dataset_info.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def num_episodes(dataset_dir: str, split: str = "train") -> Optional[int]:
    info = load_dataset_info(dataset_dir)
    for sp in info.get("splits", []):
        if sp.get("name") == split:
            lens = sp.get("shardLengths", [])
            if lens:
                return sum(int(x) for x in lens)
    return None


def decode_episode(
    features: Dict[str, Any], schema: Dict[str, FeatureSpec],
    *, keep_keys: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Parsed tf.Example features -> nested numpy episode dict.

    Sequence tensors get shape (T, *shape); encoded images stay as lists of
    bytes (decoded later in the frame pipeline); strings stay bytes."""
    out: Dict[str, Any] = {}
    for key, spec in schema.items():
        if keep_keys is not None and key not in keep_keys:
            continue
        if key not in features or features[key] is None:
            continue
        vals = features[key]
        if spec.dtype == "string" or spec.is_image:
            arr: Any = list(vals)
        else:
            np_dtype = DTYPES.get(spec.dtype, np.float32)
            arr = np.asarray(vals)
            if arr.dtype != np_dtype:
                arr = arr.astype(np_dtype)
            elem = int(np.prod(spec.shape)) if spec.shape else 1
            if spec.sequence:
                arr = arr.reshape((-1,) + spec.shape) if elem else arr.reshape(-1)
            elif spec.shape:
                arr = arr.reshape(spec.shape)
            else:
                arr = arr.reshape(()) if arr.size == 1 else arr
        _nested_set(out, key.split("/"), arr)
    return out


def _nested_set(d: Dict, parts: List[str], value):
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value
