"""Parameter partitioning rules: tree path -> axis names (port of
spatialvla_tpu/parallel/partitioning.py).

The rules and their lookup are the JAX package's, with a spec written as a
tuple of axis names (or None) where JAX writes a ``PartitionSpec``: matmul
weights cut their input feature dim over "fsdp" and their output dim over
"model"; the stacked layer axis is never cut; vectors and norms replicate.
Rules match the '/'-joined tree path with ``re.search``, first hit wins.

The port acts on the "fsdp" entries (``FsdpShards``, ZeRO-3 for the train
state) and on the "model" entries (``TensorShards``: the cut of a tree into
the trees of the model shards, which ``SpatialVLAPolicy.shard`` serves and
``TrainShards`` trains, the fsdp cut taken inside each shard).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.quant import is_grouped, is_int4, is_quantized, qmatmul_refusal
from ..utils.tree import children, iter_leaves, map_with_paths
from .mesh import (Mesh, ShardCopy, ShardGather, ShardSum, gather_along, gather_shards,
                   mesh_shape, shard_max, shard_stack, sum_shards)

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
    the fsdp axis; the rest are whole on every rank. ``TrainShards`` takes it
    inside each model shard of a train state."""

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


def shard_params(mesh: Mesh, params, rules: Rules = None):
    """This rank's shards of a whole parameter tree (partitioning.py:140)."""
    return FsdpShards(mesh, params, rules).cut_tree(params)


# ---------------------------------------------------------------------------
# the model cut of a serving tree (tensor parallelism, SpatialVLAPolicy.shard)
# ---------------------------------------------------------------------------

# The blocks of the cut, each cut as a unit or kept whole as a unit: name ->
# [(base path, role)]. Roles: "qkv" the fused q|k|v rows, by segment and q
# head with the kv heads those read; "q" / "kv" one segment of the unfused
# tree; "pair" the fused gate|up rows, gate_s | up_s; "col" output columns
# (with their bias); "row" input rows (the bias whole, added once after
# sum_shards); "vocab" the vocabulary (embed rows, head columns).
TP_BLOCKS: Dict[str, List[Tuple[str, str]]] = {
    "lm_attn": [("lm/layers/attn/qkv", "qkv"), ("lm/layers/attn/q", "q"),
                ("lm/layers/attn/k", "kv"), ("lm/layers/attn/v", "kv"),
                ("lm/layers/attn/o", "row")],
    "lm_mlp": [("lm/layers/mlp/gate_up", "pair"), ("lm/layers/mlp/gate", "col"),
               ("lm/layers/mlp/up", "col"), ("lm/layers/mlp/down", "row")],
    "vocab": [("lm/embed", "vocab"), ("lm/lm_head", "vocab")],
    "vision_attn": [("vision/layers/attn/q", "col"), ("vision/layers/attn/k", "col"),
                    ("vision/layers/attn/v", "col"), ("vision/layers/attn/o", "row")],
    "vision_mlp": [("vision/layers/mlp/fc1", "col"), ("vision/layers/mlp/fc2", "row")],
    "patch": [("vision/patch_embed", "col")],
    "projector": [("projector", "col")],
}


def _fewest_rows(block: str, cfg) -> int:
    """The fewest rows a matmul of ``block`` has: one at a decode step for the
    LM's, one image's patches for SigLIP's."""
    return 1 if block.startswith("lm") else cfg.vision.num_patches


def _node(params, path: str):
    node = params
    for k in path.split("/"):
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def _weight(node):
    """The weight of a member (a tensor, a quantized leaf, or {"w", "b"} over
    either); None for anything else (a LoRA-factored leaf)."""
    if isinstance(node, dict) and not is_quantized(node):
        if set(node) - {"w", "b"}:
            return None
        node = node.get("w")
    return node if torch.is_tensor(node) or is_quantized(node) else None


def _k_of(w) -> int:
    """The contraction width of a weight: (..., K, N) plain, (..., N, K[/2]) quantized."""
    if is_quantized(w):
        return w["qt"].shape[-1] * (2 if is_int4(w) else 1)
    return w.shape[-2]


def _nibbles(qt: torch.Tensor) -> torch.Tensor:
    """Packed int4 (..., N, K/2) -> its (..., N, K) 4-bit codes, uint8 (the
    low nibbles hold K's first half, the high ones its second)."""
    return torch.cat([qt & 15, qt >> 4], dim=-1)


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    half = codes.shape[-1] // 2
    return (codes[..., :half] | (codes[..., half:] << 4)).contiguous()


class TensorShards:
    """The model cut of a serving tree over ``n`` shards (port of the "model"
    entries of the rules as ``SpatialVLAPolicy.shard`` lays them out).

    Where GSPMD cuts each leaf evenly and keeps the program's global
    semantics, the port's layers compute with explicit heads and segments, so
    the cut follows them (see ``TP_BLOCKS``): shard s of the attention takes
    q heads [s Nq / n, (s + 1) Nq / n) and the kv heads they read (by heads
    when n divides Nkv, else the one kv head of its group, duplicated over
    n / Nkv shards); of the fused gate|up it takes gate_s | up_s; of a
    row-parallel leaf its rows of K (packed int4 repacked over the shard's K,
    grouped scales cut along G, per-channel scales and the bias whole); of the
    vocabulary the ids [s V / n, (s + 1) V / n). A block whose widths n does
    not divide stays whole, as JAX's ``_divisible`` leaves such leaves
    replicated, and so does one whose row-parallel shard would split a byte
    of packed int4 or a scale group, or that the kernels would refuse at the
    fewest rows the block's calls have (``ops/quant.py:qmatmul_refusal``),
    and a LoRA-factored leaf, which no rule names. ``blocks`` maps each block of the tree to whether it
    is cut. Every shard of a leaf is a contiguous copy; ``join_tree`` gives
    the tree back bit for bit."""

    def __init__(self, params, cfg, n: int, rules: Rules = None):
        self.cfg, self.n = cfg, n
        specs = _leaf_specs(params, rules)
        sizes = {"model": n}
        self.cuts: Dict[str, Tuple[int, List[torch.Tensor], str]] = {}
        self.blocks: Dict[str, bool] = {}
        t = cfg.text
        if t.num_heads % n == 0 and (t.num_kv_heads % n == 0 or n % t.num_kv_heads == 0):
            self.kv_heads = max(t.num_kv_heads // n, 1)
        else:
            self.kv_heads = None  # the attention stays whole
        for block, members in TP_BLOCKS.items():
            present = [(path, role, _node(params, path)) for path, role in members
                       if _node(params, path) is not None]
            if not present:
                continue
            cuts = {}
            for path, role, node in present:
                cut = self._member_cuts(block, path, role, node, specs, sizes)
                if cut is None:
                    cuts = None
                    break
                cuts.update(cut)
            self.blocks[block] = cuts is not None
            if cuts:
                self.cuts.update(cuts)

    # -- the indices of a shard ----------------------------------------------
    def _ranges(self, width: int) -> List[torch.Tensor]:
        w = width // self.n
        return [torch.arange(s * w, (s + 1) * w) for s in range(self.n)]

    def kv_index(self, s: int) -> torch.Tensor:
        """The kv heads shard s of a cut attention holds."""
        nkv = self.cfg.text.num_kv_heads
        first = s * self.kv_heads if nkv >= self.n else s // (self.n // nkv)
        return torch.arange(first, first + self.kv_heads)

    def _out_index(self, block: str, role: str, width: int) -> List[torch.Tensor]:
        t = self.cfg.text
        if block != "lm_attn":
            if role == "pair":
                return [torch.cat([r, width // 2 + r]) for r in self._ranges(width // 2)]
            return self._ranges(width)
        D = t.head_dim
        q = self._ranges(t.num_heads * D)
        kv = [(self.kv_index(s)[:, None] * D + torch.arange(D)).reshape(-1)
              for s in range(self.n)]
        if role == "q":
            return q
        if role == "kv":
            return kv
        qd, kd = t.num_heads * D, t.num_kv_heads * D
        return [torch.cat([q[s], qd + kv[s], qd + kd + kv[s]]) for s in range(self.n)]

    def _member_cuts(self, block, path, role, node, specs, sizes):
        """{leaf path: (dim, per-shard indices, how)} of one member, or None
        when the member keeps its block whole. ``how``: "plain" an index
        along ``dim``; "nibbles" along the unpacked codes' K; "groups" the
        groups of grouped scales over a K cut."""
        w = _weight(node)
        if w is None:
            return None
        wpath = path if w is node else f"{path}/w"
        leaf = f"{wpath}/qt" if is_quantized(w) else wpath
        shape = tuple(w["qt"].shape if is_quantized(w) else w.shape)
        if "model" not in _divisible(specs[leaf], shape, sizes):
            return None
        if block == "lm_attn" and self.kv_heads is None:
            return None
        if block == "vision_attn" and self.cfg.vision.num_heads % self.n:
            return None
        out: Dict[str, Tuple[int, List[torch.Tensor], str]] = {}
        if role == "vocab" and torch.is_tensor(w) and path.endswith("embed"):
            out[wpath] = (-2, self._ranges(w.shape[-2]), "plain")  # (V, H) rows
            return out
        if role == "row":
            K = _k_of(w)
            ks = K // self.n
            idx = self._ranges(K)
            if is_quantized(w):
                grouped = is_grouped(w)
                G = w["scale"].shape[-1] if grouped else 0
                if (is_int4(w) and ks % 2) or G % self.n:  # whole bytes, whole groups
                    return None
                if qmatmul_refusal(w["qt"].dtype, ks, G // self.n,
                                   _fewest_rows(block, self.cfg)):
                    return None
                out[f"{wpath}/qt"] = (-1, idx, "nibbles" if is_int4(w) else "plain")
                if grouped:
                    out[f"{wpath}/scale"] = (-1, self._ranges(w["scale"].shape[-1]), "plain")
            else:
                out[wpath] = (-2, idx, "plain")
            return out
        if is_quantized(w):
            idx = self._out_index(block, role, w["qt"].shape[-2])
            out[f"{wpath}/qt"] = (-2, idx, "plain")
            out[f"{wpath}/scale"] = (-2 if is_grouped(w) else -1, idx, "plain")
        else:
            idx = self._out_index(block, role, w.shape[-1])
            out[wpath] = (-1, idx, "plain")
        if w is not node and "b" in node:
            out[f"{path}/b"] = (-1, idx, "plain")
        return out

    # -- cut and join ----------------------------------------------------------
    def cut_leaf(self, path: str, t: torch.Tensor, s: int) -> torch.Tensor:
        """Shard s of the leaf at ``path`` (the leaf itself where it is whole)."""
        if path not in self.cuts:
            return t
        dim, idx, how = self.cuts[path]
        i = idx[s].to(t.device)
        if how == "nibbles":
            return _pack_nibbles(_nibbles(t).index_select(dim, i))
        return t.index_select(dim, i).contiguous()

    def join_leaf(self, path: str, parts: List[torch.Tensor]) -> torch.Tensor:
        if path not in self.cuts:
            return parts[0]
        dim, idx, how = self.cuts[path]
        if how == "nibbles":
            parts = [_nibbles(p) for p in parts]
        shape = list(parts[0].shape)
        shape[dim] = int(max(int(i.max()) for i in idx)) + 1
        out = parts[0].new_empty(shape)
        for i, p in zip(idx, parts):
            out.index_copy_(dim % out.dim(), i.to(out.device), p)
        return _pack_nibbles(out) if how == "nibbles" else out

    def cut_tree(self, params, s: int, device=None):
        """Shard s's tree: the cut leaves narrowed, every other leaf the same
        tensor (moved to ``device`` where given: once a device, shared by the
        shards there)."""
        def one(path, t):
            t = self.cut_leaf(path, t, s)
            return t if device is None else t.to(device)
        return map_with_paths(one, params)

    def join_tree(self, trees):
        """The whole tree from the n shard trees, on the first one's device."""
        home = next(t for _, t in iter_leaves(trees[0])).device
        flat = [dict(iter_leaves(t)) for t in trees]
        return map_with_paths(
            lambda p, t: self.join_leaf(p, [f[p].to(home) for f in flat]), trees[0])

    KV_DIMS = {"k": 2, "v": 2, "k_scale": 1, "v_scale": 1}

    def cut_state(self, state, devices):
        """A serving state (``init_serving_state``) with its KV cut over the kv
        heads of a cut attention (whole, on the first device, otherwise) into
        "shards", one dict a computing shard: "k" / "v" (L, slots, Nkv, S, D)
        along dim 2, the int8 scales (L, Nkv, 1, slots * S) along dim 1, as
        JAX's split engine shards them. The rest stays on devices[0]."""
        cut = self.blocks.get("lm_attn")
        out = {k: v for k, v in state.items() if k not in self.KV_DIMS}
        out["shards"] = [
            {k: (v.index_select(self.KV_DIMS[k], self.kv_index(s).to(v.device)).contiguous()
                 if cut else v).to(devices[s]) for k, v in state.items() if k in self.KV_DIMS}
            for s in (range(self.n) if cut else range(1))]
        return out


class ShardGroup:
    """One data group of a model-sharded tree: the trees of the model shards
    this process holds (``TensorShards.cut_tree``; ``ids`` their model
    indices, all ``n`` of them in one process) and their devices, shard 0's
    the group's home, where the replicated activations live and the whole
    blocks run (once, not once a shard). ``run`` / ``reduce`` / ``gather``
    apply a block's computation to each shard that holds it, through the
    model axis' collectives (``parallel/mesh.py``: ShardCopy, ShardSum,
    ShardGather; over ``comm``, the model axis' process group, where each
    rank holds one shard), so gradients flow through them. A whole tree is a
    group of one (``as_group``: no cut, no device of its own), whose
    ``reduce`` and ``gather`` hand back its one result, so the layers run
    one loop for a whole tree and for its model shards."""

    def __init__(self, cut: Optional[TensorShards], trees, devices, *, ids=None, comm=None):
        self.cut, self.trees = cut, list(trees)
        self.devices = [None if d is None else torch.device(d) for d in devices]
        self.ids = list(range(len(self.trees))) if ids is None else list(ids)
        self.comm = comm
        self.n, self.home = (1 if cut is None else cut.n), self.devices[0]
        self.distinct = len(set(self.devices)) > 1
        self._layers: Dict[str, list] = {}

    @property
    def sharded(self) -> bool:
        """Whether this is a data group of a mesh, not a whole tree's group of one."""
        return self.cut is not None

    def is_cut(self, block: str) -> bool:
        return self.cut is not None and self.cut.blocks.get(block, False)

    def shards(self, block: str) -> range:
        """The positions in ``trees`` of the shards that compute ``block``:
        all of them where it is cut, the first alone where it is whole."""
        return range(len(self.trees)) if self.is_cut(block) else range(1)

    def layers(self, part: str, L: int) -> List[list]:
        """Each shard's per-layer views of ``part``'s L stacked layers ("lm"
        or "vision"), made once."""
        if part not in self._layers:
            from ..models.gemma2 import unstack_layers

            self._layers[part] = [unstack_layers(t[part]["layers"], L) for t in self.trees]
        return self._layers[part]

    def with_layers(self, part: str, views: List[dict]) -> "ShardGroup":
        """A group of the same shards whose per-layer views of ``part`` are
        ``views`` (one {layer: tree} a shard; a pipeline stage's, rebuilt
        from leaves of their own graph), so its layers compute with those
        and their gradients reach them; ``self`` and its views untouched."""
        group = ShardGroup(self.cut, self.trees, self.devices, ids=self.ids, comm=self.comm)
        group._layers[part] = list(views)
        return group

    def text_cfg(self, tcfg):
        """The LM config ``tcfg`` of one shard of the attention (its q and kv heads)."""
        import dataclasses

        if not self.is_cut("lm_attn"):
            return tcfg
        return dataclasses.replace(tcfg, num_heads=tcfg.num_heads // self.n,
                                   num_kv_heads=self.cut.kv_heads)

    def to_home(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.home is None else t.to(self.home)

    def run(self, block: str, fn, *args) -> List:
        """[fn(s, tree_s, *args on shard s's device) for each position s of
        ``block``'s shards]. Over a cut block a float argument that takes a
        gradient goes to the shards through ``ShardCopy``."""
        shards = self.shards(block)
        cut = self.is_cut(block) and not self.distinct
        per_arg = [ShardCopy.apply(self.comm, len(shards), a)
                   if cut and torch.is_tensor(a) and a.requires_grad else (a,) * len(shards)
                   for a in args]
        out = []
        for i, s in enumerate(shards):
            dev = self.devices[s]
            out.append(fn(s, self.trees[s], *(a[i].to(dev) if dev is not None
                                               and torch.is_tensor(a[i]) else a[i]
                                               for a in per_arg)))
        return out

    def reduce(self, block: str, fn, *args) -> torch.Tensor:
        """The shards' partial results of ``block`` summed (``ShardSum``;
        ``sum_shards`` across distinct devices), on the home device."""
        parts = self.run(block, fn, *args)
        return self.sum_parts(parts) if self.is_cut(block) else parts[0]

    def gather(self, block: str, fn, *args, dim: int = -1) -> torch.Tensor:
        """The shards' column blocks of ``block`` joined in order, on the home
        device."""
        parts = self.run(block, fn, *args)
        if not self.is_cut(block):
            return parts[0]
        if self.distinct:
            return gather_shards(parts, dim)
        return ShardGather.apply(self.comm, dim, *parts)

    def sum_parts(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Every model shard's part summed (this process's parts, and over
        ``comm`` every rank's)."""
        if self.distinct:
            return sum_shards(parts)[0]
        return ShardSum.apply(self.comm, *parts)

    def max_parts(self, parts: List[torch.Tensor]) -> torch.Tensor:
        return shard_max(parts, self.comm)

    def stack_parts(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Every model shard's part stacked along a new last dim, in shard order."""
        return shard_stack(parts, self.comm)


def as_group(params, part: Optional[str] = None) -> ShardGroup:
    """``params`` itself where it is a ``ShardGroup``, else the group of one
    of the whole tree ``params`` (``{part: params}`` where ``params`` is the
    subtree ``part``, as "lm" for the Gemma2 stack's own tree)."""
    if isinstance(params, ShardGroup):
        return params
    return ShardGroup(None, [params if part is None else {part: params}], [None])


class ShardedParams:
    """A serving tree sharded over a ``LocalMesh`` of data x model shards
    (``SpatialVLAPolicy.shard``): ``groups`` one ``ShardGroup`` a data group.
    Groups whose shards lie on the same devices share one group (and its
    tensors)."""

    def __init__(self, cut: TensorShards, groups: List[ShardGroup]):
        self.cut, self.groups = cut, groups

    @classmethod
    def shard(cls, params, cfg, mesh, default_device, rules: Rules = None) -> "ShardedParams":
        cut = TensorShards(params, cfg, mesh.model, rules)
        made: Dict[tuple, ShardGroup] = {}
        groups = []
        for g in range(mesh.data):
            devices = tuple(mesh.group_devices(g, default_device))
            if devices not in made:
                made[devices] = ShardGroup(
                    cut, [cut.cut_tree(params, s, devices[s]) for s in range(mesh.model)],
                    devices)
            groups.append(made[devices])
        return cls(cut, groups)


# ---------------------------------------------------------------------------
# the cut of a train state over the model and fsdp axes (training)
# ---------------------------------------------------------------------------

def _replace_leaves(tree, fn, path: str = ""):
    """Every tensor leaf of nested dicts and lists replaced IN PLACE by
    ``fn(path, leaf)``, each whole tensor let go as soon as its replacement
    is made."""
    for k in list(tree) if isinstance(tree, dict) else range(len(tree)):
        p = f"{path}/{k}" if path else str(k)
        if isinstance(tree[k], (dict, list)):
            _replace_leaves(tree[k], fn, p)
        elif torch.is_tensor(tree[k]):
            tree[k] = fn(p, tree[k])
    return tree


class TrainShards:
    """The cut of a train state over a mesh's model and fsdp axes, and the
    gradient reductions of the sharded step (``train.make_train_step``).

    The model cut is ``TensorShards``' (heads, hidden columns, the
    vocabulary; a block stays whole where n does not divide its widths, as
    JAX's ``_divisible`` replicates), taken alike of the fp32 masters and
    both AdamW moments. A leaf cut over model holds the shards of this
    process stacked along a new leading dim: ``ids`` are their model indices,
    all ``n`` on a ``LocalMesh`` (this process runs them in turn) and this
    rank's one on a ``Mesh``. A whole leaf is one tensor, the one master that
    every shard reads. On a ``Mesh`` the fsdp cut (``FsdpShards``) is taken
    inside each model shard (``fsdp=False``: none, as for a LoRA base).
    ``group`` makes the step's ``ShardGroup``; ``gather_state`` joins a state
    back into the unsharded tree bit for bit (checkpoints, the export) and
    ``cut_state_leaf`` cuts a stored whole leaf again (restore).

    Gradients (``reduce_grad``): a leaf cut over model keeps its shard's; a
    whole leaf has the same full gradient on every model shard and is not
    summed over them; a kv head held by n / Nkv shards (n > Nkv) takes the
    sum of its copies' gradients, so the copies stay equal. ``grad_square``
    counts each parameter once for ``grad_norm``."""

    STATE_ROOTS = ("params/", "opt_state/mu/", "opt_state/nu/")
    KV = ("lm/layers/attn/k", "lm/layers/attn/v")

    def __init__(self, mesh, params, cfg=None, rules: Rules = None, *, fsdp: bool = True):
        self.mesh, self.n = mesh, mesh_shape(mesh)["model"]
        self.process = isinstance(mesh, Mesh)
        if self.n > 1 and cfg is None:
            raise ValueError("the model cut follows the model's heads: pass its config (cfg=)")
        self.cut = TensorShards(params, cfg, self.n, rules) if self.n > 1 else None
        self.ids = [mesh.index("model")] if self.process else list(range(self.n))
        self.comm = mesh.group("model") if self.process and self.n > 1 else None
        self.copies = 1
        if self.cut is not None and self.cut.blocks.get("lm_attn"):
            self.copies = max(self.n // cfg.text.num_kv_heads, 1)
        shard = map_with_paths(self._shard_like, params)
        self.fsdp = FsdpShards(mesh, shard, rules) if self.process and fsdp else None

    def _shard_like(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """A meta tensor of one model shard's shape of the leaf at ``path``."""
        shape = list(t.shape)
        if self.stacked(path):
            dim, idx, _ = self.cut.cuts[path]
            shape[dim] = len(idx[0])
        return torch.empty(shape, dtype=t.dtype, device="meta")

    def stacked(self, path: str) -> bool:
        """Whether the leaf at ``path`` is cut over model (its shards stacked)."""
        return self.cut is not None and path in self.cut.cuts

    def fsdp_dim(self, path: str) -> Optional[int]:
        """The dim of this process's leaf at ``path`` that the fsdp cut takes."""
        dim = None if self.fsdp is None or self.fsdp.n == 1 else self.fsdp.dim(path)
        return None if dim is None else dim + self.stacked(path)

    def param_path(self, state_path: str) -> Optional[str]:
        """The parameter a train state's leaf (a master or a moment) is of."""
        for root in self.STATE_ROOTS:
            if state_path.startswith(root):
                return state_path[len(root):]
        return None

    # -- cut and join ----------------------------------------------------------
    def cut_leaf(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This process's leaf of the whole tensor of parameter ``path`` (a
        copy where it is cut; the tensor itself where it is whole)."""
        if not self.stacked(path) and self.fsdp_dim(path) is None:
            return t
        t = t.detach()
        if self.stacked(path):
            dim, idx, _ = self.cut.cuts[path]
            out = t.new_empty([len(self.ids)] + list(self._shard_like(path, t).shape))
            for i, s in enumerate(self.ids):
                torch.index_select(t, dim, idx[s].to(t.device), out=out[i])
            t = out
        dim = self.fsdp_dim(path)
        return t if dim is None else self.fsdp.cut(t, dim)

    def join_leaf(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``path`` from this process's leaf (a
        collective on a ``Mesh``; detached)."""
        t = t.detach()
        dim = self.fsdp_dim(path)
        if dim is not None:
            t = self.fsdp.gather(t, dim)
        if not self.stacked(path):
            return t
        if self.comm is not None:
            t = gather_along(t, self.comm, 0)
        return self.cut.join_leaf(path, list(t.unbind(0)))

    def cut_tree(self, params):
        """``params`` cut IN PLACE (each whole leaf let go as it is cut)."""
        return _replace_leaves(params, self.cut_leaf)

    def cut_state(self, state):
        """A train state (``init_train_state``) with its masters and moments
        cut IN PLACE, each whole leaf let go as it is cut."""
        def one(p, t):
            param = self.param_path(p)
            return t if param is None else self.cut_leaf(param, t)
        return _replace_leaves(state, one)

    def cut_state_leaf(self, state_path: str, t: torch.Tensor) -> torch.Tensor:
        """This process's leaf of a state leaf stored whole (a restore)."""
        param = self.param_path(state_path)
        return t if param is None else self.cut_leaf(param, t)

    def gather_tree(self, params):
        """The whole parameter tree (a collective on a ``Mesh``)."""
        return map_with_paths(self.join_leaf, params)

    def gather_state(self, state, *, in_place: bool = False):
        """The whole train state (a collective on a ``Mesh``); ``in_place``
        rewrites ``state`` itself, each cut leaf let go as it is joined."""
        def one(p, t):
            param = self.param_path(p) if torch.is_tensor(t) else None
            return t if param is None else self.join_leaf(param, t)
        return _replace_leaves(state, one) if in_place else map_with_paths(one, state)

    # -- the step --------------------------------------------------------------
    def compute_tree(self, masters):
        """The tree the step computes with: each fsdp-cut leaf gathered (a
        leaf of its own), every other float leaf the master itself; every
        float leaf takes a gradient."""
        def one(path, t):
            if not (torch.is_tensor(t) and t.is_floating_point()):
                return t
            dim = self.fsdp_dim(path)
            if dim is None:
                return t.requires_grad_(True)
            return self.fsdp.gather(t.detach(), dim).requires_grad_(True)
        return map_with_paths(one, masters)

    def group(self, tree, *, lora=None, alpha: float = 32.0, rank: int = 32):
        """This process's model shards of ``tree`` (a compute tree, or a LoRA
        base with its saved leaves) as a ``ShardGroup``: each stacked leaf
        unbound into its shards, the whole leaves shared. With ``lora`` (a
        factor tree) each shard's adapted leaves take the factors' matching
        block (``lora_apply_tree``): the columns of ``b`` of a
        column-parallel leaf, the rows of ``a`` of a row-parallel one. The
        tree itself without a model cut."""
        if self.cut is None:
            return tree
        views = {p: t.unbind(0) for p, t in iter_leaves(tree) if self.stacked(p)}
        trees = [map_with_paths(lambda p, t, i=i: views[p][i] if p in views else t, tree)
                 for i in range(len(self.ids))]
        if lora is not None:
            from ..train.lora import lora_apply_tree

            trees = [lora_apply_tree(t, self.factor_blocks(lora, s), alpha=alpha, rank=rank)
                     for t, s in zip(trees, self.ids)]
        return ShardGroup(self.cut, trees, [None] * len(trees), ids=self.ids, comm=self.comm)

    def factor_blocks(self, lora, s: int):
        """Model shard s's blocks of a LoRA factor tree (path -> {"a", "b"})."""
        out = {}
        for path, f in lora.items():
            a, b = f["a"], f["b"]
            if self.stacked(path):
                dim, idx, _ = self.cut.cuts[path]
                i = idx[s].to(a.device)
                if dim % b.dim() == b.dim() - 1:
                    b = b.index_select(-1, i)
                else:
                    a = a.index_select(-2, i)
            out[path] = {"a": a, "b": b}
        return out

    def reduce_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """This process's gradient of the leaf at ``path`` from the compute
        tree's: the copies of a duplicated kv head summed; on a ``Mesh``
        reduce-scattered over fsdp where the leaf is fsdp-cut and summed over
        the batch, sp and pipe axes (never over model)."""
        if self.copies > 1 and path in self.KV and self.stacked(path):
            g = self._sum_copies(g)
        if not self.process:
            return g
        dim = self.fsdp_dim(path)
        if dim is not None:
            g = self.fsdp.reduce_scatter(g, dim)
            torch.distributed.all_reduce(g, group=self.mesh.group("data", "sp", "pipe"))
        else:
            torch.distributed.all_reduce(g, group=self.mesh.group("data", "fsdp", "sp", "pipe"))
        return g

    def _sum_copies(self, g: torch.Tensor) -> torch.Tensor:
        """Each shard's gradient of a kv head replaced by the sum, in shard
        order, over the shards that hold that head."""
        every = g if self.comm is None else gather_along(g, self.comm, 0)
        out = torch.empty_like(g)
        for i, s in enumerate(self.ids):
            first = s - s % self.copies
            total = every[first].clone()
            for c in range(first + 1, first + self.copies):
                total += every[c]
            out[i] = total
        return out

    def grad_square(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """The squared sum of this process's gradient of ``path`` as far as
        it counts it: a leaf whole over fsdp on fsdp rank 0 alone, a leaf
        whole over model on model shard 0 alone, a duplicated kv head on its
        first copy alone; summed over the ranks of (fsdp, model), each
        parameter counts once."""
        g = g.float()
        if self.stacked(path) and self.copies > 1 and path in self.KV:
            g = g[[i for i, s in enumerate(self.ids) if s % self.copies == 0]]
        skip = ((not self.stacked(path) and self.ids[0] != 0)
                    or (self.fsdp_dim(path) is None and self.fsdp is not None
                        and self.fsdp.index != 0))
        return g.new_zeros(()) if skip else g.pow(2).sum()

    def sum_squares(self, sq: torch.Tensor) -> torch.Tensor:
        """The squares of ``grad_square`` summed over (fsdp, model) (a
        collective on a ``Mesh``)."""
        if self.process:
            torch.distributed.all_reduce(sq, group=self.mesh.group("fsdp", "model"))
        return sq
