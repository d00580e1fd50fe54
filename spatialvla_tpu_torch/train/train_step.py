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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..errors import not_ported
from ..models import spatialvla
from ..utils.tree import iter_leaves, map_with_paths
from .lora import DEFAULT_SAVED, extract_saved, insert_saved, lora_apply_tree, lora_init
from .loss import chunked_loss_and_metrics
from .metrics import action_metrics
from .optimizer import AdamW

Params = Dict[str, Any]

_INT_KEYS = ("input_ids", "labels")


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    use_remat: bool = True
    compute_dtype: Any = torch.bfloat16
    micro_steps: int = 1  # gradient accumulation
    attn_backend: str = "xla"  # "xla" | "flash" (the flash-attention kernels)
    # sequence-chunked CE: caps logits memory at B x chunk x vocab; 0 = full logits
    loss_chunk_size: int = 0


def batch_to_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device``: ids and labels
    int64, masks and token types int32, floats float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if k in _INT_KEYS:
            t = t.long()
        elif t.is_floating_point():
            t = t.float()
        else:
            t = t.int()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_loss_fn(cfg, step_cfg: TrainStepConfig, luts=None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics) (train_step.py:42)."""
    if step_cfg.attn_backend in ("ring", "pipeline"):
        raise not_ported(f"attn_backend={step_cfg.attn_backend!r}", "parallel")

    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]):
        attn = batch.get("attention_mask")
        if attn is None:
            attn = torch.ones_like(batch["input_ids"], dtype=torch.int32)
        chunked = step_cfg.loss_chunk_size > 0
        out = spatialvla.forward(
            params, cfg, batch["input_ids"],
            pixel_values=batch.get("pixel_values"),
            intrinsic=batch.get("intrinsic"),
            attention_mask=attn,
            token_type_ids=batch.get("token_type_ids"),
            labels=None if chunked else batch["labels"],
            depth=batch.get("depth"),
            use_remat=step_cfg.use_remat,
            compute_dtype=step_cfg.compute_dtype,
            attn_backend=step_cfg.attn_backend,
            with_logits=not chunked,
        )
        if chunked:
            return chunked_loss_and_metrics(
                params["lm"], cfg.text, out["hidden"], batch["labels"], attn,
                begin_idx=cfg.action_token_begin_idx, luts=luts,
                chunk_size=step_cfg.loss_chunk_size,
            )
        metrics = action_metrics(out["logits"], batch["labels"], attn,
                                 begin_idx=cfg.action_token_begin_idx, luts=luts)
        metrics["loss"] = out["loss"]
        return out["loss"], metrics

    return loss_fn


def _grad_leaves(params):
    return [(path, p) for path, p in iter_leaves(params)
            if torch.is_tensor(p) and p.requires_grad]


def make_train_step(cfg, tx: AdamW, step_cfg: TrainStepConfig = TrainStepConfig(),
                    luts=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    state = {'params', 'opt_state', 'step'} (from ``init_train_state``);
    batch leaves are (B, ...) or (M, B, ...) with step_cfg.micro_steps = M.
    Gradients of the M micro-batches are summed in fp32 and divided by M;
    the metrics are their means."""
    loss_fn = make_loss_fn(cfg, step_cfg, luts=luts)
    M = step_cfg.micro_steps

    def train_step(state, batch):
        params = state["params"]
        leaves = _grad_leaves(params)
        device = leaves[0][1].device
        for _, p in leaves:
            p.grad = None
        batch = batch_to_tensors(batch, device)
        micro = [batch] if M == 1 else [{k: v[m] for k, v in batch.items()} for m in range(M)]
        per_micro = []
        for mb in micro:
            loss, metrics = loss_fn(params, mb)
            loss.backward()
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        metrics = {k: torch.stack([m[k] for m in per_micro]).float().mean()
                   for k in per_micro[0]}
        grads = {}
        for path, p in leaves:
            if p.grad is not None and M > 1:
                p.grad.div_(M)
            grads[path] = p.grad
        present = [g for g in grads.values() if g is not None]
        metrics["grad_norm"] = torch.sqrt(torch.stack([g.float().pow(2).sum()
                                                       for g in present]).sum())
        tx.update(params, grads, state["opt_state"])
        for _, p in leaves:
            p.grad = None
        state["step"] += 1
        return state, metrics

    return train_step


def make_lora_train_step(cfg, tx: AdamW, step_cfg: TrainStepConfig = TrainStepConfig(), *,
                         alpha: float = 32.0, rank: int = 32, luts=None) -> Callable:
    """LoRA step (train_step.py:141): train_step(state, base_params, batch)
    -> (state, metrics), with state = {'trainable': {'lora', 'saved'},
    'opt_state', 'step'} from ``init_lora_train_state`` and the frozen base
    tree a separate argument (no optimizer state for it). The metrics are
    the loss function's; JAX's LoRA step adds no grad_norm. One batch a
    step, as in JAX (no micro-batches)."""
    if step_cfg.micro_steps != 1:
        raise ValueError("the LoRA step takes one batch a step (micro_steps=1), as JAX's does")
    loss_inner = make_loss_fn(cfg, step_cfg, luts=luts)

    def train_step(state, base_params, batch):
        trainable = state["trainable"]
        leaves = _grad_leaves(trainable)
        for _, p in leaves:
            p.grad = None
        base = map_with_paths(lambda _, t: t.detach(), base_params)
        params = insert_saved(base, trainable["saved"])
        params = lora_apply_tree(params, trainable["lora"], alpha=alpha, rank=rank)
        loss, metrics = loss_inner(params, batch_to_tensors(batch, leaves[0][1].device))
        loss.backward()
        tx.update(trainable, {path: p.grad for path, p in leaves}, state["opt_state"])
        for _, p in leaves:
            p.grad = None
        state["step"] += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


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
