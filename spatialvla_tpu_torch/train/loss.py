"""Sequence-chunked cross-entropy and action metrics (port of
spatialvla_tpu/train/loss.py).

The 265k-token vocabulary makes full-sequence logits the training step's
largest activation (B x T x V fp32). Each chunk of ``chunk_size`` positions
projects hidden -> logits, reduces to (loss sum, argmax) and is recomputed in
the backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint`` at
loss.py:70), so at most one chunk's logits exist at a time. The last chunk
is shorter where the JAX package pads it with ignored labels; the sums are
the same."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.gemma2 import compute_logits
from ..models.layers import softcap
from ..ops.quant import qmatmul
from .metrics import metrics_from_predictions


def position_loss(lm_params: Dict, cfg, hidden: torch.Tensor, targets: torch.Tensor,
                  valid: torch.Tensor, *, chunk_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL over the ``valid`` positions, argmax ids)
    of ``hidden`` (B, S, H) against ``targets`` (B, S), the positions'
    next tokens. ``chunk_size`` > 0 projects chunk by chunk, each chunk
    recomputed in the backward pass; 0 takes the full logits in fp32 as
    ``gemma2.compute_logits`` does (``cross_entropy_loss``'s route)."""
    head = lm_params["lm_head"] if "lm_head" in lm_params else lm_params["embed"].t()

    def stats(logits, lab, ok):
        logp = torch.log_softmax(logits, dim=-1)
        safe = torch.where(ok, lab, torch.zeros_like(lab)).long()
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return torch.where(ok, nll, torch.zeros_like(nll)).sum(), torch.argmax(logits, dim=-1)

    if chunk_size <= 0:
        return stats(compute_logits(lm_params, cfg, hidden), targets, valid)

    def chunk_stats(h, lab, ok):
        return stats(softcap(qmatmul(h, head).float(), cfg.final_logit_softcap), lab, ok)

    loss_sum, preds = hidden.new_zeros((), dtype=torch.float32), []
    S = hidden.shape[1]
    for c0 in range(0, S, chunk_size):
        c1 = min(c0 + chunk_size, S)
        part, p = checkpoint(chunk_stats, hidden[:, c0:c1], targets[:, c0:c1], valid[:, c0:c1],
                             use_reentrant=False)
        loss_sum = loss_sum + part
        preds.append(p)
    return loss_sum, torch.cat(preds, dim=1)


def chunked_loss_and_metrics(
    lm_params: Dict,
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
