"""Optimizer, learning-rate schedule and freezing policy (port of
spatialvla_tpu/train/optimizer.py), with optax's semantics:

* ``make_schedule``: linear warmup from 0 over ``warmup_ratio`` of the
  steps, then linear (or cosine) decay to 0, or constant; the update with
  count c uses schedule(c), so the first update uses schedule(0) = 0.
* ``make_optimizer``: on the trainable leaves only (optax.multi_transform),
  ``clip_by_global_norm`` (the norm over the trainable gradients;
  g unchanged when the norm is below the limit, else (g / norm) * limit)
  then AdamW (bias-corrected moments, mu_hat / (sqrt(nu_hat) + eps), plus
  weight_decay * p, times -lr). Frozen leaves get no update and no state.

The JAX version returns new trees; this one updates the parameters and the
moments in place (no second copy of a 2.5 B-parameter tree).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from ..utils.tree import iter_leaves, map_with_paths


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    warmup_ratio: float = 0.005
    total_steps: int = 100_000
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "linear"  # linear | cosine | constant


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """step -> learning rate (optimizer.py:36: optax.join_schedules of a
    linear warmup and the decay)."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    decay_steps = max(cfg.total_steps - warmup, 1)
    lr = cfg.learning_rate

    def linear(init, end, steps, count):
        count = min(max(count, 0), steps)
        return (init - end) * (1.0 - count / steps) + end

    def decay(count):
        if cfg.schedule == "constant":
            return lr
        if cfg.schedule == "cosine":
            count = min(count, decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        if cfg.schedule == "linear":
            return linear(lr, 0.0, decay_steps, count)
        raise ValueError(f"unknown schedule {cfg.schedule!r}")

    return lambda step: linear(0.0, lr, warmup, step) if step < warmup else decay(step - warmup)


def trainable_mask(params: Dict[str, Any], *, freeze_llm_embed: bool = True,
                   freeze_vision: bool = False, freeze_zoe: bool = True,
                   extra_frozen_paths: tuple = ()) -> Dict[str, Any]:
    """Nested dict of bools, True = trainable (optimizer.py:53)."""

    def decide(p, _leaf):
        if freeze_zoe and p.startswith("zoe"):
            return False
        if freeze_vision and p.startswith("vision"):
            return False
        if freeze_llm_embed and p in ("lm/embed", "embed"):
            return False
        return not any(p.startswith(f) for f in extra_frozen_paths)

    return map_with_paths(decide, params)


class AdamW:
    """clip_by_global_norm + adamw on the trainable leaves (make_optimizer)."""

    def __init__(self, cfg: OptimizerConfig, mask: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.trainable = None if mask is None else dict(iter_leaves(mask))

    def is_trainable(self, path: str) -> bool:
        return self.trainable is None or bool(self.trainable[path])

    def init(self, params) -> Dict[str, Any]:
        mu, nu = {}, {}
        for path, p in iter_leaves(params):
            if self.is_trainable(path):
                mu[path] = torch.zeros_like(p, dtype=torch.float32)
                nu[path] = torch.zeros_like(p, dtype=torch.float32)
        return {"count": 0, "mu": mu, "nu": nu}

    @torch.no_grad()
    def update(self, params, grads: Dict[str, Optional[torch.Tensor]], state, *,
               norm: Optional[torch.Tensor] = None) -> float:
        """Applies one update in place: ``grads`` maps a leaf's path to its
        gradient (None = zero; a clipped gradient is scaled in place).
        ``norm``, when given, is the trainable gradients' global norm (a
        sharded step's, over every rank's shards); else it is taken here.
        Returns the learning rate used."""
        cfg = self.cfg
        leaves = [(path, p, grads.get(path)) for path, p in iter_leaves(params)
                  if self.is_trainable(path)]
        if norm is None:
            sq = [g.float().pow(2).sum() for _, _, g in leaves if g is not None]
            norm = torch.sqrt(torch.stack(sq).sum()) if sq else None
        clip = norm is not None and not float(norm) < cfg.grad_clip  # one host sync
        lr = self.schedule(state["count"])
        state["count"] += 1
        count = state["count"]
        bc1, bc2 = 1.0 - cfg.b1 ** count, 1.0 - cfg.b2 ** count
        for path, p, g in leaves:
            if g is None:
                if not cfg.weight_decay:
                    continue  # zero gradient, zero moments: a zero update
                g = torch.zeros_like(p)
            elif clip:  # clip_by_global_norm, in place on the gradient
                g.div_(norm).mul_(cfg.grad_clip)
            mu, nu = state["mu"][path], state["nu"][path]
            mu.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
            nu.mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
            if cfg.weight_decay:
                update.add_(p, alpha=cfg.weight_decay)
            p.add_(update.to(p.dtype), alpha=-lr)
        return lr


def make_optimizer(cfg: OptimizerConfig, params: Optional[Dict[str, Any]] = None,
                   mask: Optional[Dict[str, Any]] = None) -> AdamW:
    """The optimizer of optimizer.py:82; ``params`` is accepted for the JAX
    signature (the state is made by ``init``)."""
    return AdamW(cfg, mask)
