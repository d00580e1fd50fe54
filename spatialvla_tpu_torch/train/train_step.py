"""The train step (port of spatialvla_tpu/train/train_step.py): bf16 compute
over fp32 master parameters, activation checkpointing, micro-batch gradient
accumulation, on-device action metrics.

The parameters are the JAX tree's nested dict of fp32 leaf tensors with
``requires_grad``; the compute casts a weight to the activation dtype where
it is used (``qmatmul``'s ``x @ w.to(x.dtype)``), so gradients arrive in
fp32 on the masters. Every float leaf gets a gradient, frozen or not (the
ZoeDepth branch runs under ``torch.no_grad`` and gets none), because the
reported ``grad_norm`` is the norm of all of them (train_step.py:131),
frozen LM embedding included; the optimizer then updates only the trainable
leaves. Parameters and moments are updated in place, and ``state`` is
returned as the same dict.

The LoRA step (``make_lora_train_step``, train_step.py:141) trains a state
of its own, the factors and the 'saved' tensors (``train/lora.py``), over a
base tree passed beside it that is detached every step: the base takes no
gradient and no update.

``mesh=`` takes the "ring" / "pipeline" backends (a ``LocalMesh`` runs them
in this process), a ``LocalMesh(model=n)`` (the model axis held by this
process: n tensor-parallel shards run in turn on its device; with sp or pipe
too, each shard running its own ring over its heads, or its part of each
pipeline stage) and a process-group ``Mesh``: the sharded step, the
counterpart of ``jit_train_step`` (train_step.py:210-245), set up by
``shard_train_step`` and bound to the state's cut
(``parallel.TrainShards``). Each process holds its own rows of the batch
(its block on data x fsdp; the same rows on every model, sp and pipe rank).
The fp32 masters and AdamW moments are cut over model by heads, hidden
columns and the vocabulary (``TensorShards``), and inside each model shard
over fsdp by the partitioning rules (ZeRO-3): the fsdp-cut weights are
gathered for the compute, and the gradients reduce-scattered back to the
shards and summed over data, sp and pipe. A leaf cut over model keeps its
shard's gradient; a whole leaf has the same full gradient on every model
shard and is not summed over them; a kv head held by several shards takes
the sum of its copies'. Each rank's loss is its part of the global mean: its
positions' NLL over the global count of valid targets, divided by the ranks
that compute the same positions (the pipe ranks, and the sp ranks but under
"ring"), so that every contribution enters the summed gradient once; the
model ranks compute the same loss (the vocabulary cut's cross-entropy
reduces over them: ``train/loss.py``). Every rank reports the same metrics:
the loss summed across ranks, the rest from the gathered predictions;
``grad_norm`` and the clip take the norm of the whole sharded gradient, each
parameter counted once, one all-reduce of the squared sums. The LoRA step
under a mesh holds its small trainable state whole on every rank; its base
is cut over model (``shard_lora_train_step``), each shard's adapted leaves
taking the factors' matching block, and the gradients are summed over the
mesh, those of the factors of a cut leaf (partial over the model shards)
over model too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..models import spatialvla
from ..parallel.mesh import AXES, Mesh, gather_along, mesh_shape
from ..parallel.partitioning import ShardGroup, TrainShards
from ..utils.tree import iter_leaves, map_with_paths
from .lora import DEFAULT_SAVED, extract_saved, insert_saved, lora_apply_tree, lora_init
from .loss import chunked_loss_and_metrics, position_loss
from .metrics import action_metrics, metrics_from_predictions
from .optimizer import AdamW

Params = Dict[str, Any]

_INT_KEYS = ("input_ids", "labels")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    use_remat: bool = True
    compute_dtype: Any = torch.bfloat16
    micro_steps: int = 1  # gradient accumulation
    # "xla" | "flash" (the flash-attention kernels) | "ring" (sequence
    # parallelism over the mesh's sp axis) | "pipeline" (GPipe stages over
    # its pipe axis); the last two need make_*_train_step(mesh=...)
    attn_backend: str = "xla"
    pp_microbatches: int = 0  # "pipeline": microbatches a step (0: one a stage)
    # sequence-chunked CE: caps logits memory at B x chunk x vocab; 0 = full logits
    loss_chunk_size: int = 0


def batch_to_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device``: ids and labels
    int64, masks and token types int32, floats float32."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "to_local"):  # a DTensor of form_global_batch: this process's rows
            v = v.to_local()
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k in _INT_KEYS:
            t = t.long()
        elif t.is_floating_point():
            t = t.float()
        else:
            t = t.int()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_loss_fn(cfg, step_cfg: TrainStepConfig, luts=None, mesh=None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics) (train_step.py:42), params
    the tree or, over a model axis, a ShardGroup of this process's shards
    (``TrainShards.group``). On a process-group ``Mesh``, the loss is this
    rank's part of the global one (``_sharded_loss_fn``)."""
    if step_cfg.attn_backend in ("ring", "pipeline") and mesh is None:
        raise ValueError(f"attn_backend={step_cfg.attn_backend!r} requires "
                         "make_*_train_step(mesh=...)")
    _check_model_axis(mesh)
    if isinstance(mesh, Mesh):
        return _sharded_loss_fn(cfg, step_cfg, luts, mesh)

    def loss_fn(params, batch: Dict[str, torch.Tensor]):
        attn = _attention_mask(batch)
        # over model shards the loss takes the vocabulary-parallel route
        chunked = step_cfg.loss_chunk_size > 0 or isinstance(params, ShardGroup)
        out = _forward(params, cfg, step_cfg, batch, attn, mesh, labels=not chunked)
        if chunked:
            return chunked_loss_and_metrics(
                _lm(params), cfg.text, out["hidden"], batch["labels"], attn,
                begin_idx=cfg.action_token_begin_idx, luts=luts,
                chunk_size=step_cfg.loss_chunk_size,
            )
        metrics = action_metrics(out["logits"], batch["labels"], attn,
                                 begin_idx=cfg.action_token_begin_idx, luts=luts)
        metrics["loss"] = out["loss"]
        return out["loss"], metrics

    return loss_fn


def _lm(params):
    """What the loss projects with: a ShardGroup, or the LM tree."""
    return params if isinstance(params, ShardGroup) else params["lm"]


def _check_model_axis(mesh):
    """Raises where a LocalMesh would train its model shards across cards or
    data groups."""
    if mesh_shape(mesh)["model"] == 1:
        return
    if not isinstance(mesh, Mesh) and (mesh.devices is not None or mesh.data > 1):
        raise ValueError("a LocalMesh trains its model shards on the caller's device "
                         "(devices=None, data=1): training across cards is one process per "
                         "card (make_mesh over a process group)")


def _attention_mask(batch):
    attn = batch.get("attention_mask")
    return torch.ones_like(batch["input_ids"], dtype=torch.int32) if attn is None else attn


def _forward(params, cfg, step_cfg, batch, attn, mesh, *, labels: bool):
    return spatialvla.forward(
        params, cfg, batch["input_ids"],
        pixel_values=batch.get("pixel_values"),
        intrinsic=batch.get("intrinsic"),
        attention_mask=attn,
        token_type_ids=batch.get("token_type_ids"),
        labels=batch["labels"] if labels else None,
        depth=batch.get("depth"),
        use_remat=step_cfg.use_remat,
        compute_dtype=step_cfg.compute_dtype,
        attn_backend=step_cfg.attn_backend,
        mesh=mesh,
        pp_microbatches=step_cfg.pp_microbatches,
        with_logits=labels,
    )


def _sharded_loss_fn(cfg, step_cfg: TrainStepConfig, luts, mesh: Mesh) -> Callable:
    """loss_fn(params, batch) -> (this rank's loss, global metrics) on a
    process-group mesh (see the module docstring)."""
    from ..parallel.ring_attention import seq_shard

    ring = step_cfg.attn_backend == "ring"
    replicas = mesh.shape["pipe"] * (1 if ring else mesh.shape["sp"])
    rows, seq = mesh.group("data", "fsdp"), mesh.group("sp")
    positions = mesh.group("data", "fsdp", "sp") if ring else rows  # each target once
    ignore = cfg.ignore_index

    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]):
        attn = _attention_mask(batch)
        T = batch["input_ids"].shape[1]
        out = _forward(params, cfg, step_cfg, batch, attn, mesh, labels=False)
        start, stop = seq_shard(mesh, T) if ring else (0, T)
        stop_t = min(stop, T - 1)  # the last position has no next token
        targets = batch["labels"][:, start + 1:stop_t + 1]
        valid = (targets != ignore) & (attn[:, start + 1:stop_t + 1] != 0)
        loss_sum, preds = position_loss(_lm(params), cfg.text, out["hidden"][:, :stop_t - start],
                                        targets, valid, chunk_size=step_cfg.loss_chunk_size)
        count = valid.sum()
        torch.distributed.all_reduce(count, group=positions)
        loss = loss_sum / count.clamp_min(1)
        reported = loss.detach().clone()
        torch.distributed.all_reduce(reported, group=positions)
        if ring:
            width = stop - start  # every shard's pieces padded to one width
            pad = lambda t, v: torch.nn.functional.pad(t, (0, width - t.shape[1]), value=v)  # noqa: E731
            preds, targets, valid = (gather_along(pad(t, v), seq, 1)[:, :T - 1]
                                     for t, v in ((preds, 0), (targets, ignore), (valid.byte(), 0)))
        preds, targets, valid = (gather_along(t, rows, 0) for t in (preds, targets, valid.byte()))
        valid = valid.bool()
        metrics = metrics_from_predictions(preds, targets, valid,
                                           begin_idx=cfg.action_token_begin_idx, luts=luts)
        metrics["loss"] = reported
        return (loss / replicas if replicas > 1 else loss), metrics

    return loss_fn


def _grad_leaves(params):
    return [(path, p) for path, p in iter_leaves(params)
            if torch.is_tensor(p) and p.requires_grad]


def make_train_step(cfg, tx: AdamW, step_cfg: TrainStepConfig = TrainStepConfig(),
                    luts=None, mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    state = {'params', 'opt_state', 'step'} (from ``init_train_state``);
    batch leaves are (B, ...) or (M, B, ...) with step_cfg.micro_steps = M.
    Gradients of the M micro-batches are summed in fp32 and divided by M;
    the metrics are their means. On a process-group ``Mesh`` or a
    ``LocalMesh`` with a model axis the step is train_step(state, batch,
    shards) on a state cut by ``shard_train_step``, which binds the shards."""
    loss_fn = make_loss_fn(cfg, step_cfg, luts=luts, mesh=mesh)
    M = step_cfg.micro_steps

    def grads_and_metrics(params, batch, device, compute=None):
        """(path -> gradient of ``params``' leaves, metrics) of one step, the
        loss taken of ``compute`` (a ShardGroup over them) or of ``params``."""
        leaves = _grad_leaves(params)
        for _, p in leaves:
            p.grad = None
        batch = batch_to_tensors(batch, device)
        micro = [batch] if M == 1 else [{k: v[m] for k, v in batch.items()} for m in range(M)]
        per_micro = []
        for mb in micro:
            loss, metrics = loss_fn(params if compute is None else compute, mb)
            loss.backward()
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        metrics = {k: torch.stack([m[k] for m in per_micro]).float().mean()
                   for k in per_micro[0]}
        grads = {}
        for path, p in leaves:
            if p.grad is not None and M > 1:
                p.grad.div_(M)
            grads[path] = p.grad
            p.grad = None
        return grads, metrics

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = grads_and_metrics(params, batch, _grad_leaves(params)[0][1].device)
        present = [g for g in grads.values() if g is not None]
        metrics["grad_norm"] = torch.sqrt(torch.stack([g.float().pow(2).sum()
                                                       for g in present]).sum())
        tx.update(params, grads, state["opt_state"])
        state["step"] += 1
        return state, metrics

    def sharded_step(state, batch, shards: TrainShards):
        masters = state["params"]
        # the compute tree: each fsdp-cut leaf gathered whole (a leaf of its
        # own), the rest the masters themselves; over model, their shards
        full = shards.compute_tree(masters)
        device = _grad_leaves(full)[0][1].device
        grads, metrics = grads_and_metrics(full, batch, device, shards.group(full))
        local, sq, trainable = {}, [], []
        for path, g in grads.items():
            if g is None:
                local[path] = None
                continue
            local[path] = g = shards.reduce_grad(path, g)
            sq.append(shards.grad_square(path, g))
            trainable.append(tx.is_trainable(path))
        sq = shards.sum_squares(torch.stack(sq))
        metrics["grad_norm"] = torch.sqrt(sq.sum())
        keep = torch.tensor(trainable, device=sq.device)
        norm = torch.sqrt(sq[keep].sum()) if bool(keep.any()) else None
        tx.update(masters, local, state["opt_state"], norm=norm)
        state["step"] += 1
        return state, metrics

    sharded_step.cfg = cfg
    return sharded_step if _sharded(mesh) else train_step


def _sharded(mesh) -> bool:
    """Whether a step over ``mesh`` runs on a cut state: a process group, or
    a model axis held by this process."""
    return isinstance(mesh, Mesh) or mesh_shape(mesh)["model"] > 1


class ShardedStep:
    """A sharded train step bound to its state's cut: ``step(state, batch)``,
    as ``train_loop`` calls it; ``shards`` is what a ``CheckpointManager``
    gathers and cuts by."""

    def __init__(self, step: Callable, shards: TrainShards):
        self.step, self.shards = step, shards

    def __call__(self, state, batch):
        return self.step(state, batch, self.shards)


def shard_train_step(train_step: Callable, mesh, state, *, rules=None):
    """(step, state) for the step of ``make_train_step(mesh=mesh)``: the
    counterpart of ``jit_train_step`` (train_step.py:210-245). On a
    process-group ``Mesh`` or a model axis the state's parameters and AdamW
    moments are cut IN PLACE to this process's shards (``TrainShards``:
    over model by the heads and widths, inside each shard over fsdp by the
    partitioning rules; each whole tensor let go as it is cut) and the step
    is bound to that cut; elsewhere both come back as they are."""
    if not _sharded(mesh):
        return train_step, state
    shards = TrainShards(mesh, state["params"], train_step.cfg, rules)
    return ShardedStep(train_step, shards), shards.cut_state(state)


def make_lora_train_step(cfg, tx: AdamW, step_cfg: TrainStepConfig = TrainStepConfig(), *,
                         alpha: float = 32.0, rank: int = 32, luts=None, mesh=None) -> Callable:
    """LoRA step (train_step.py:141): train_step(state, base_params, batch)
    -> (state, metrics), with state = {'trainable': {'lora', 'saved'},
    'opt_state', 'step'} from ``init_lora_train_state`` and the frozen base
    tree a separate argument (no optimizer state for it). The metrics are
    the loss function's; JAX's LoRA step adds no grad_norm. One batch a
    step, as in JAX (no micro-batches). On a process-group ``Mesh`` the
    gradients are summed over the mesh before the update. With a model axis
    the step is bound to its base's cut by ``shard_lora_train_step``."""
    if step_cfg.micro_steps != 1:
        raise ValueError("the LoRA step takes one batch a step (micro_steps=1), as JAX's does")
    loss_inner = make_loss_fn(cfg, step_cfg, luts=luts, mesh=mesh)

    def train_step(state, base_params, batch, shards: TrainShards = None):
        trainable = state["trainable"]
        leaves = _grad_leaves(trainable)
        for _, p in leaves:
            p.grad = None
        base = map_with_paths(lambda _, t: t.detach(), base_params)
        params = insert_saved(base, trainable["saved"])
        if shards is not None:  # each model shard's base block and factor blocks
            params = shards.group(params, lora=trainable["lora"], alpha=alpha, rank=rank)
        else:
            params = lora_apply_tree(params, trainable["lora"], alpha=alpha, rank=rank)
        loss, metrics = loss_inner(params, batch_to_tensors(batch, leaves[0][1].device))
        loss.backward()
        if isinstance(mesh, Mesh):
            # a factor of a leaf cut over model has partial gradients on the
            # model shards; every other leaf its whole gradient on each
            for path, p in leaves:
                factor = path.startswith("lora/") and shards is not None and shards.stacked(
                    path[len("lora/"):].rsplit("/", 1)[0])
                axes = AXES if factor else ("data", "fsdp", "sp", "pipe")
                torch.distributed.all_reduce(p.grad, group=mesh.group(*axes))
        tx.update(trainable, {path: p.grad for path, p in leaves}, state["opt_state"])
        for _, p in leaves:
            p.grad = None
        state["step"] += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    train_step.cfg = cfg
    return train_step


def shard_lora_train_step(train_step: Callable, mesh, base_params, *, rules=None):
    """(step, base) for the step of ``make_lora_train_step(mesh=mesh)``: with
    a model axis the frozen base is cut IN PLACE over model (``TrainShards``,
    no fsdp cut: the base stays whole on the batch axes, as the LoRA state
    does) and the step is bound to that cut; elsewhere both come back as
    they are."""
    if mesh_shape(mesh)["model"] == 1:
        return train_step, base_params
    shards = TrainShards(mesh, base_params, train_step.cfg, rules, fsdp=False)
    return functools.partial(train_step, shards=shards), shards.cut_tree(base_params)


def init_lora_train_state(generator: torch.Generator, base_params: Params, tx: AdamW, *,
                          target_patterns, rank: int = 32, saved_patterns=None) -> Dict[str, Any]:
    """{'trainable': {'lora': factors, 'saved': copies of the saved tensors},
    'opt_state', 'step'}; every trainable tensor takes a gradient. The saved
    tensors are copied, so the step's in-place updates leave the base tree
    as it was."""
    saved = extract_saved(base_params, saved_patterns or DEFAULT_SAVED)
    trainable = {
        "lora": lora_init(generator, base_params, target_patterns=target_patterns, rank=rank),
        "saved": {p: t.detach().clone() for p, t in saved.items()},
    }
    for _, p in iter_leaves(trainable):
        p.requires_grad_(True)
    return {"trainable": trainable, "opt_state": tx.init(trainable), "step": 0}


def init_train_state(params: Params, tx: AdamW) -> Dict[str, Any]:
    """{'params', 'opt_state', 'step'}; every float leaf of ``params`` is
    made a leaf that takes a gradient (in place)."""
    for _, p in iter_leaves(params):
        if torch.is_tensor(p) and p.is_floating_point():
            p.requires_grad_(True)
    return {"params": params, "opt_state": tx.init(params), "step": 0}
