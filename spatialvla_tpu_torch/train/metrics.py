"""Training metrics on the device (port of spatialvla_tpu/train/metrics.py):
next-token accuracies restricted to the action-token id ranges, and the
continuous L1 between decoded predicted and target actions through
id -> action lookup tables, with no host round-trip in the step."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..action import SpatialActionTokenizer


def build_decode_luts(tok: SpatialActionTokenizer) -> Dict[str, np.ndarray]:
    """Dense id -> continuous-action lookup tables for the device-side L1."""
    return {
        "translation": tok.translation.decode(np.arange(tok.translation.vocab_size))
        .astype(np.float32),  # (Nt, 3)
        "rotation": tok.rotation.decode(np.arange(tok.rotation.vocab_size))
        .astype(np.float32),  # (Nr, 3)
        "gripper": tok.gripper.decode(np.arange(tok.gripper.vocab_size))
        .astype(np.float32),  # (Ng, 1)
    }


def metrics_from_predictions(preds, targets, valid, *, begin_idx, n_translation=4096,
                             n_rotation=4096, n_gripper=2, luts=None) -> Dict[str, torch.Tensor]:
    """Accuracies (and, with luts, the L1) from (B, S) next-token predictions,
    targets and the valid-target mask (metrics.py:54-88, loss.py:88-121)."""
    t0, t1 = begin_idx, begin_idx + n_translation
    r1 = t1 + n_rotation
    g1 = r1 + n_gripper

    def range_acc(lo, hi):
        in_range = valid & (targets >= lo) & (targets < hi)
        correct = in_range & (preds == targets)
        return correct.sum() / in_range.sum().clamp_min(1), in_range

    acc_all, _ = range_acc(t0, g1)
    acc_t, in_t = range_acc(t0, t1)
    acc_r, in_r = range_acc(t1, r1)
    acc_g, in_g = range_acc(r1, g1)
    out = {
        "accuracy": acc_all,
        "translation_accuracy": acc_t,
        "rotation_accuracy": acc_r,
        "gripper_accuracy": acc_g,
    }
    if luts is not None:
        def group_l1(lut, in_range, lo, n):
            lut = torch.as_tensor(lut, device=preds.device)
            p = torch.clamp(preds - lo, 0, n - 1)
            t = torch.clamp(targets - lo, 0, n - 1)
            d = (lut[p] - lut[t]).abs().sum(-1)
            return torch.where(in_range, d, torch.zeros_like(d)).sum()

        total = (group_l1(luts["translation"], in_t, t0, n_translation)
                 + group_l1(luts["rotation"], in_r, t1, n_rotation)
                 + group_l1(luts["gripper"], in_g, r1, n_gripper))
        out["l1_loss"] = total / (7 * in_t.sum().clamp_min(1))  # one triplet per step
    return out


def action_metrics(logits, labels, attention_mask, *, begin_idx: int, n_translation: int = 4096,
                   n_rotation: int = 4096, n_gripper: int = 2,
                   luts: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Metrics from full (B, T, V) logits (metrics.py:41)."""
    preds = torch.argmax(logits[:, :-1], dim=-1)
    targets = labels[:, 1:]
    valid = (targets != -100) & (attention_mask[:, 1:] != 0)
    return metrics_from_predictions(preds, targets, valid, begin_idx=begin_idx,
                                    n_translation=n_translation, n_rotation=n_rotation,
                                    n_gripper=n_gripper, luts=luts)
