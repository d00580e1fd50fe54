"""Sequence-chunked cross-entropy and action metrics (port of
spatialvla_tpu/train/loss.py).

The 265k-token vocabulary makes full-sequence logits the training step's
largest activation (B x T x V fp32). Each chunk of ``chunk_size`` positions
projects hidden -> logits, reduces to (loss sum, argmax) and is recomputed in
the backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint`` at
loss.py:70), so at most one chunk's logits exist at a time. The last chunk
is shorter where the JAX package pads it with ignored labels; the sums are
the same. Over model shards whose vocabulary is cut, the cross-entropy and
the argmax reduce over the shards (``vocab_parallel_stats``): no shard
holds the whole logits."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.gemma2 import _head_of, compute_logits
from ..models.layers import softcap
from ..ops.quant import qmatmul
from ..parallel.partitioning import as_group
from .metrics import metrics_from_predictions


def position_loss(lm_params, cfg, hidden: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor, *, chunk_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL over the ``valid`` positions, argmax ids)
    of ``hidden`` (B, S, H) against ``targets`` (B, S), the positions'
    next tokens. ``chunk_size`` > 0 projects chunk by chunk, each chunk
    recomputed in the backward pass; 0 takes the full logits in fp32 as
    ``gemma2.compute_logits`` does (``cross_entropy_loss``'s route).

    ``lm_params`` is the LM tree or a ShardGroup of model shards. Over a
    vocabulary cut (``vocab_parallel_stats``) each shard projects onto its
    own ids: the max and the sum of exponents are reduced over the shards,
    the target's logit comes from the shard that owns its id, and the argmax
    is the global one (ties to the lower id, as ``torch.argmax`` breaks
    them)."""
    tp = as_group(lm_params, "lm")

    def shard_logits(s, tree, h):
        """fp32 softcapped logits of shard s's ids (every id where whole)."""
        if chunk_size <= 0:
            return compute_logits({"lm_head": _head_of(tree["lm"])}, cfg, h)
        return softcap(qmatmul(h, _head_of(tree["lm"])).float(), cfg.final_logit_softcap)

    if tp.is_cut("vocab"):
        def stats(h, lab, ok):
            return vocab_parallel_stats(tp, tp.run("vocab", shard_logits, h), lab, ok,
                                        cfg.vocab_size // tp.n)
    else:
        def stats(h, lab, ok):
            logits = shard_logits(0, tp.trees[0], h)
            logp = torch.log_softmax(logits, dim=-1)
            safe = torch.where(ok, lab, torch.zeros_like(lab)).long()
            nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
            return (torch.where(ok, nll, torch.zeros_like(nll)).sum(),
                    torch.argmax(logits, dim=-1))

    if chunk_size <= 0:
        return stats(hidden, targets, valid)
    loss_sum, preds = hidden.new_zeros((), dtype=torch.float32), []
    S = hidden.shape[1]
    for c0 in range(0, S, chunk_size):
        c1 = min(c0 + chunk_size, S)
        part, p = checkpoint(stats, hidden[:, c0:c1], targets[:, c0:c1], valid[:, c0:c1],
                             use_reentrant=False)
        loss_sum = loss_sum + part
        preds.append(p)
    return loss_sum, torch.cat(preds, dim=1)


def vocab_parallel_stats(tp, parts, lab: torch.Tensor, ok: torch.Tensor,
                         width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NLL summed over the ``ok`` positions, global argmax ids) from the
    fp32 logits ``parts`` of the model shards of ``tp`` this process holds,
    each over ``width`` ids from ``tp.ids[i] * width``."""
    lo = [tp.ids[i] * width for i in range(len(parts))]
    m = tp.max_parts([p.detach().amax(-1) for p in parts])  # the global max, a constant
    sumexp = tp.sum_parts([torch.exp(p - m[..., None]).sum(-1) for p in parts])

    def target_logit(p, first):
        local = lab - first
        own = ok & (local >= 0) & (local < width)
        got = torch.gather(p, -1, local.clamp(0, width - 1).long()[..., None])[..., 0]
        return torch.where(own, got, torch.zeros_like(got))

    target = tp.sum_parts([target_logit(p, first) for p, first in zip(parts, lo)])
    nll = torch.log(sumexp) + m - target
    nll = torch.where(ok, nll, torch.zeros_like(nll)).sum()
    best = tp.stack_parts([p.detach().amax(-1) for p in parts])  # (..., n) in id order
    ids = tp.stack_parts([torch.argmax(p.detach(), -1) + first for p, first in zip(parts, lo)])
    return nll, torch.gather(ids, -1, torch.argmax(best, -1, keepdim=True))[..., 0]


def chunked_loss_and_metrics(
    lm_params,  # the LM tree or a ShardGroup
    cfg,
    hidden: torch.Tensor,  # (B, T, H) final-normed decoder output
    labels: torch.Tensor,  # (B, T)
    attention_mask: torch.Tensor,  # (B, T)
    *,
    begin_idx: int,
    luts: Optional[Dict] = None,
    chunk_size: int = 256,
    ignore_index: int = -100,
    n_translation: int = 4096,
    n_rotation: int = 4096,
    n_gripper: int = 2,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    targets = labels[:, 1:]
    valid = (targets != ignore_index) & (attention_mask[:, 1:] != 0)
    loss_sum, preds = position_loss(lm_params, cfg, hidden[:, :-1], targets, valid,
                                    chunk_size=chunk_size)
    loss = loss_sum / valid.sum().clamp_min(1)
    metrics = {"loss": loss}
    metrics.update(metrics_from_predictions(
        preds, targets, valid, begin_idx=begin_idx,
        n_translation=n_translation, n_rotation=n_rotation, n_gripper=n_gripper, luts=luts))
    return loss, metrics
