"""Parameter partitioning rules: tree path -> axis names (port of
spatialvla_tpu/parallel/partitioning.py).

The rules and their lookup are the JAX package's, with a spec written as a
tuple of axis names (or None) where JAX writes a ``PartitionSpec``: matmul
weights cut their input feature dim over "fsdp" and their output dim over
"model"; the stacked layer axis is never cut; vectors and norms replicate.
Rules match the '/'-joined tree path with ``re.search``, first hit wins.

The port acts on the "fsdp" entries (``FsdpShards``, ZeRO-3 for the train
state); the "model" entries stay in the specs for the tensor-parallel slice
still to port (ROADMAP.md).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.quant import is_quantized
from ..utils.tree import children, iter_leaves, map_with_paths
from .mesh import Mesh, gather_along, mesh_shape

Spec = Tuple[Optional[str], ...]
Rules = List[Tuple[str, Spec]]

# (path regex, spec) - specs are for the *trailing* dims of each leaf;
# leading stack dims are padded with None (partitioning.py:23-54)
DEFAULT_RULES: Rules = [
    # Gemma2 LM
    (r"lm/embed$", ("model", "fsdp")),          # (V, H): vocab over model
    (r"lm/lm_head$", ("fsdp", "model")),        # (H, V)
    (r"lm/layers/attn/[qkv]$", ("fsdp", "model")),  # (H, N*D): heads over model
    (r"lm/layers/attn/qkv$", ("fsdp", "model")),    # fused serving tree
    (r"lm/layers/attn/o$", ("model", "fsdp")),      # (N*D, H)
    (r"lm/layers/mlp/(gate|up)$", ("fsdp", "model")),
    (r"lm/layers/mlp/gate_up$", ("fsdp", "model")),  # fused serving tree
    (r"lm/layers/mlp/down$", ("model", "fsdp")),
    (r"lm/.*norm", (None,)),
    # SigLIP tower
    (r"vision/patch_embed/w$", (None, None, None, "model")),
    (r"vision/layers/attn/[qkv]/w$", ("fsdp", "model")),
    (r"vision/layers/attn/o/w$", ("model", "fsdp")),
    (r"vision/layers/mlp/fc1/w$", ("fsdp", "model")),
    (r"vision/layers/mlp/fc2/w$", ("model", "fsdp")),
    (r"vision/pos_embed$", (None, "fsdp")),
    # projector / ego3d / spatial embeddings
    (r"projector/w$", ("fsdp", "model")),
    (r"spatial_embed$", ("fsdp", None)),
    (r"ego3d/fc\d/w$", (None, "fsdp")),
    # Zoe (frozen; the big backbone linears over fsdp)
    (r"zoe/.*(w|weight)$", (None, "fsdp")),
    # standalone gemma2 tree (no "lm/" prefix)
    (r"^embed$", ("model", "fsdp")),
    (r"^lm_head$", ("fsdp", "model")),
    (r"^layers/attn/[qkv]$", ("fsdp", "model")),
    (r"^layers/attn/o$", ("model", "fsdp")),
    (r"^layers/mlp/(gate|up)$", ("fsdp", "model")),
    (r"^layers/mlp/down$", ("model", "fsdp")),
]


def spec_for(path_str: str, ndim: int, rules: Rules = None) -> Spec:
    """The spec of a leaf of ``ndim`` dims at ``path_str`` (() replicates)."""
    for pattern, spec in rules or DEFAULT_RULES:
        if re.search(pattern, path_str):
            tail = tuple(spec)
            if len(tail) < ndim:  # pad leading stack dims (the layer axis)
                tail = (None,) * (ndim - len(tail)) + tail
            elif len(tail) > ndim:
                tail = tail[-ndim:]
            return tail
    return ()


def _divisible(spec: Spec, shape, mesh) -> Spec:
    """Drop the axes whose mesh size does not divide the dim (a blanket rule
    can hit tiny dims, e.g. Zoe's 1- or 2-channel head convs); the spec is
    then as long as the leaf. Without a mesh, the spec as it is."""
    if mesh is None:
        return spec
    sizes = mesh_shape(mesh)
    out = [ax if ax is None or dim % sizes[ax] == 0 else None
           for dim, ax in zip(shape[-len(spec):] if spec else (), spec)]
    return (None,) * (len(shape) - len(out)) + tuple(out)


def _quant_specs(path_str: str, node: Dict[str, Any], rules: Rules) -> Dict[str, Spec]:
    """Specs of a quantized {'qt', 'scale'} leaf: stored transposed, so an
    original (K, N) rule (a, b) gives qt (b, a) and the per-channel scale
    (b,), grouped scales (N, G) (b, None); looked up by the base path."""
    qt, scale = node["qt"], node["scale"]
    base = spec_for(path_str, 2, rules)
    a, b = base if len(base) == 2 else (None, None)
    qt_spec = (None,) * (qt.dim() - 2) + (b, a)
    if scale.dim() == qt.dim():  # grouped
        scale_spec = (None,) * (scale.dim() - 2) + (b, None)
    else:
        scale_spec = (None,) * (scale.dim() - 1) + (b,)
    return {"qt": qt_spec, "scale": scale_spec}


def _leaf_specs(params, rules: Rules) -> Dict[str, Spec]:
    """path -> spec before the mesh check, quantized leaves included."""
    out: Dict[str, Spec] = {}

    def walk(node, path):
        if isinstance(node, dict) and is_quantized(node):
            for k, s in _quant_specs(path, node, rules).items():
                out[f"{path}/{k}"] = s
            return
        kids = children(node)
        if kids is None:
            out[path] = spec_for(path, node.dim(), rules)
            return
        for k, v in kids:
            walk(v, f"{path}/{k}" if path else str(k))

    walk(params, "")
    return out


def param_pspecs(params, rules: Rules = None, mesh=None):
    """A tree of specs mirroring ``params`` (partitioning.py:119). With a
    ``mesh`` (a ``Mesh``, ``LocalMesh`` or dict of axis sizes) the
    indivisible axes fall back to replicated. Quantized leaves take their
    base path's rule with the transposed-storage axis swap."""
    flat = _leaf_specs(params, rules)
    return map_with_paths(lambda p, leaf: _divisible(flat[p], tuple(leaf.shape), mesh), params)


class FsdpShards:
    """The fsdp cut of a parameter tree on a ``Mesh``: each leaf whose spec
    names "fsdp" is cut along that dim into ``n`` equal shards, one a rank of
    the fsdp axis; the rest are whole on every rank. Also cuts, gathers and
    reduces a train state's leaves (``params/<path>`` and the AdamW moments
    ``opt_state/mu/<path>``, ``opt_state/nu/<path>``)."""

    STATE_ROOTS = ("params/", "opt_state/mu/", "opt_state/nu/")

    def __init__(self, mesh: Mesh, params, rules: Rules = None):
        self.mesh = mesh
        self.n = mesh.shape["fsdp"]
        self.index = mesh.index("fsdp")
        self.group = mesh.group("fsdp")
        specs = _leaf_specs(params, rules)
        self.dims: Dict[str, int] = {}
        for path, leaf in iter_leaves(params):
            spec = _divisible(specs[path], tuple(leaf.shape), mesh)
            if "fsdp" in spec:
                self.dims[path] = spec.index("fsdp")

    def dim(self, path: str) -> Optional[int]:
        """The dim a parameter path is cut along (None: whole)."""
        return self.dims.get(path)

    def state_dim(self, state_path: str) -> Optional[int]:
        for root in self.STATE_ROOTS:
            if state_path.startswith(root):
                return self.dims.get(state_path[len(root):])
        return None

    def cut(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's shard of a whole tensor (a contiguous copy)."""
        if dim is None or self.n == 1:
            return t
        return t.detach().chunk(self.n, dim)[self.index].clone(
            memory_format=torch.contiguous_format)

    def gather(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The whole tensor from every rank's shard."""
        if dim is None or self.n == 1:
            return t
        return gather_along(t, self.group, dim)

    def reduce_scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard of the sum over the fsdp axis of a whole
        gradient."""
        out = torch.empty_like(g.chunk(self.n, dim)[0], memory_format=torch.contiguous_format)
        chunks = [c.contiguous() for c in g.chunk(self.n, dim)]
        torch.distributed.reduce_scatter(out, chunks, group=self.group)
        return out

    def cut_tree(self, params):
        return map_with_paths(lambda p, t: self.cut(t, self.dim(p)), params)

    def gather_tree(self, params):
        """The whole parameter tree from every rank's shards (a collective)."""
        return map_with_paths(lambda p, t: self.gather(t.detach(), self.dim(p)), params)

    def cut_state(self, state):
        """A train state (``init_train_state``) with its parameters and
        moments cut to this rank's shards."""
        return map_with_paths(
            lambda p, t: self.cut(t, self.state_dim(p)) if torch.is_tensor(t) else t, state)

    def gather_state(self, state):
        """The whole train state from every rank's shards (a collective)."""
        return map_with_paths(
            lambda p, t: self.gather(t.detach(), self.state_dim(p)) if torch.is_tensor(t) else t,
            state)


def shard_params(mesh: Mesh, params, rules: Rules = None):
    """This rank's shards of a whole parameter tree (partitioning.py:140)."""
    return FsdpShards(mesh, params, rules).cut_tree(params)
