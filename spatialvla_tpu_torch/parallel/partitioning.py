"""Parameter partitioning rules: tree path -> axis names (port of
spatialvla_tpu/parallel/partitioning.py).

The rules and their lookup are the JAX package's, with a spec written as a
tuple of axis names (or None) where JAX writes a ``PartitionSpec``: matmul
weights cut their input feature dim over "fsdp" and their output dim over
"model"; the stacked layer axis is never cut; vectors and norms replicate.
Rules match the '/'-joined tree path with ``re.search``, first hit wins.

The port acts on the "fsdp" entries (``FsdpShards``, ZeRO-3 for the train
state) and, for serving, on the "model" entries (``TensorShards``: the cut of
a serving tree into the trees of the model shards that ``SpatialVLAPolicy.shard``
runs; the model axis in training is ROADMAP item 8c).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.quant import is_grouped, is_int4, is_quantized, qmatmul_refusal
from ..utils.tree import children, iter_leaves, map_with_paths
from .mesh import Mesh, gather_along, gather_shards, mesh_shape, sum_shards

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
    """One data group of a sharded serving tree: the trees of its ``n`` model
    shards (``TensorShards.cut_tree``) and their devices, shard 0's the
    group's home, where the replicated activations live and the whole blocks
    run (once, not once a shard). ``run`` / ``reduce`` / ``gather`` apply a
    block's computation to each shard that holds it. A whole tree is a group
    of one (``as_group``: no cut, no device of its own), whose ``reduce`` and
    ``gather`` hand back its one result, so the layers run one loop for a
    whole tree and for its model shards."""

    def __init__(self, cut: Optional[TensorShards], trees, devices):
        self.cut, self.trees = cut, list(trees)
        self.devices = [None if d is None else torch.device(d) for d in devices]
        self.n, self.home = len(self.trees), self.devices[0]
        self._layers: Dict[str, list] = {}

    @property
    def sharded(self) -> bool:
        """Whether this is a data group of a mesh, not a whole tree's group of one."""
        return self.cut is not None

    def is_cut(self, block: str) -> bool:
        return self.cut is not None and self.cut.blocks.get(block, False)

    def shards(self, block: str) -> range:
        """The shards that compute ``block``: all of them where it is cut,
        shard 0 alone where it is whole."""
        return range(self.n) if self.is_cut(block) else range(1)

    def layers(self, part: str, L: int) -> List[list]:
        """Each shard's per-layer views of ``part``'s L stacked layers ("lm"
        or "vision"), made once."""
        if part not in self._layers:
            from ..models.gemma2 import unstack_layers

            self._layers[part] = [unstack_layers(t[part]["layers"], L) for t in self.trees]
        return self._layers[part]

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
        """[fn(s, tree_s, *args on shard s's device) for each shard of ``block``]."""
        out = []
        for s in self.shards(block):
            dev = self.devices[s]
            out.append(fn(s, self.trees[s], *(a.to(dev) if dev is not None and torch.is_tensor(a)
                                               else a for a in args)))
        return out

    def reduce(self, block: str, fn, *args) -> torch.Tensor:
        """The shards' partial results of ``block`` summed (``sum_shards``), on
        the home device."""
        parts = self.run(block, fn, *args)
        return sum_shards(parts)[0] if len(parts) > 1 else parts[0]

    def gather(self, block: str, fn, *args, dim: int = -1) -> torch.Tensor:
        """The shards' column blocks of ``block`` joined in order, on the home
        device."""
        parts = self.run(block, fn, *args)
        return gather_shards(parts, dim) if len(parts) > 1 else parts[0]


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
