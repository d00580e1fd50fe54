"""Trajectory-level transforms, pure NumPy.

The reference implements these as tf.data graph ops (data/traj_transforms.py,
data/utils/data_utils.py, data/utils/goal_relabeling.py,
data/utils/task_augmentation.py) under dlimp. This pipeline is tf-free:
trajectories are nested dicts of numpy arrays with a shared leading time
dimension, and transforms are plain functions — the host CPU work is
vectorized numpy; TPUs never see any of this.

Semantics parity (golden-tested against the reference TF functions):
  - chunk_act_obs (traj_transforms.py:12-74): obs backward window with
    stride, floored at 0 with pad_mask; action forward window clamped to the
    goal timestep; actions past goal become neutral (zeros for relative
    dims, repeated for absolute dims);
  - normalize_action_and_proprio (data_utils.py:58-110): normal or
    bounds/q99 clip-to-[-1,1] with per-dim mask, zero-width dims -> 0;
  - binarize_gripper_actions (data_utils.py:113-145): reverse scan
    propagating the next decisive (open/closed) state through in-between
    values;
  - rel2abs_gripper_actions (data_utils.py:152-175);
  - relabel_bridge_actions (data_utils.py:179-189);
  - goal relabeling 'uniform' (goal_relabeling.py:15-32) and
    delete_task_conditioning (task_augmentation.py:14-61).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

Traj = Dict[str, Any]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_merge(*trees):
    """Later trees override earlier ones, recursing into dicts."""
    out: Dict[str, Any] = {}
    for tree in trees:
        for k, v in tree.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = tree_merge(out[k], v)
            else:
                out[k] = v
    return out


def to_padding(x: np.ndarray) -> np.ndarray:
    if x.dtype.kind in ("U", "S", "O"):
        return np.full_like(x, "")
    return np.zeros_like(x)


# ---------------------------------------------------------------------------
# chunking
# ---------------------------------------------------------------------------

def chunk_act_obs(
    traj: Traj,
    backward_window_size: int = 0,
    backward_delta: int = 1,
    forward_window_size: int = 0,
) -> Traj:
    """Windows observations backward and actions forward in time.

    observation[t] -> stack over offsets (-W..0)*delta, floored at 0, with
    observation.pad_mask marking pre-trajectory padding; action[t] -> stack
    over offsets 0..F clamped to the goal timestep; actions past the goal
    are replaced by neutral actions (zeros where relative, repeat where
    absolute)."""
    T = len(traj["action"])
    action_dim = traj["action"].shape[-1]

    offs = np.arange(-backward_window_size, 1) * backward_delta
    chunk_idx = offs[None, :] + np.arange(T)[:, None]  # (T, W+1)
    floored_chunk_idx = np.maximum(chunk_idx, 0)

    act_offs = np.arange(0, 1 + forward_window_size)
    act_idx = act_offs[None, :] + np.arange(T)[:, None]  # (T, F+1)

    goal_timestep = traj.get("task", {}).get("timestep")
    if goal_timestep is None:
        goal_timestep = np.full((T,), T - 1)
    floored_act_idx = np.minimum(np.maximum(act_idx, 0), goal_timestep[:, None])

    traj["observation"] = tree_map(lambda x: x[floored_chunk_idx], traj["observation"])
    chunked_action = traj["action"][floored_act_idx]  # (T, F+1, D)

    traj["observation"]["pad_mask"] = chunk_idx >= 0

    absolute_action_mask = traj.get(
        "absolute_action_mask", np.zeros((T, action_dim), dtype=bool)
    )
    neutral = np.where(
        absolute_action_mask[:, None, :], chunked_action, np.zeros_like(chunked_action)
    )
    past_goal = act_idx > goal_timestep[:, None]
    traj["action"] = np.where(past_goal[:, :, None], neutral, chunked_action)
    return traj


def subsample(traj: Traj, subsample_length: int, rng: np.random.Generator) -> Traj:
    T = len(traj["action"])
    if T > subsample_length:
        idx = rng.permutation(T)[:subsample_length]
        # only gather time-indexed array leaves: the canonical traj also
        # carries scalar metadata (dataset_name str) the reference's
        # all-tensor trajs don't have
        traj = tree_map(
            lambda x: x[idx]
            if isinstance(x, np.ndarray) and x.ndim >= 1 and len(x) == T
            else x,
            traj,
        )
    return traj


def add_pad_mask_dict(traj: Traj) -> Traj:
    T = len(traj["action"])
    for key in ("observation", "task"):
        pad = {}
        for subkey, v in traj[key].items():
            if isinstance(v, np.ndarray) and v.dtype.kind in ("U", "S", "O"):
                lengths = np.array([len(s) for s in v.reshape(-1)]).reshape(v.shape)
                pad[subkey] = lengths != 0
            else:
                pad[subkey] = np.ones((T,), dtype=bool)
        traj[key]["pad_mask_dict"] = pad
    return traj


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def normalize_action_and_proprio(
    traj: Traj, metadata: Dict, normalization_type: str = "bounds_q99"
) -> Traj:
    """Keys: 'action' stats normalize traj['action']; 'proprio' stats
    normalize traj['observation']['proprio'] (if present)."""

    def apply(key, traj_get, traj_set):
        x = traj_get()
        if x is None:
            return
        stats = {k: np.asarray(v) for k, v in metadata[key].items()}
        mask = stats.get("mask", np.ones_like(stats[next(iter(stats))], dtype=bool)).astype(bool)
        if normalization_type == "normal":
            y = np.where(mask, (x - stats["mean"]) / (stats["std"] + 1e-8), x)
        elif normalization_type in ("bounds", "bounds_q99"):
            low = stats["min"] if normalization_type == "bounds" else stats["q01"]
            high = stats["max"] if normalization_type == "bounds" else stats["q99"]
            y = np.where(
                mask, np.clip(2 * (x - low) / (high - low + 1e-8) - 1, -1, 1), x
            )
            y = np.where(stats["min"] == stats["max"], 0.0, y)
        else:
            raise ValueError(f"unknown normalization {normalization_type}")
        traj_set(y.astype(x.dtype))

    apply("action", lambda: traj.get("action"), lambda y: traj.__setitem__("action", y))
    if "proprio" in traj.get("observation", {}):
        apply(
            "proprio",
            lambda: traj["observation"]["proprio"],
            lambda y: traj["observation"].__setitem__("proprio", y),
        )
    return traj


# ---------------------------------------------------------------------------
# gripper relabeling
# ---------------------------------------------------------------------------

def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Continuous [0,1] gripper -> binary, resolving in-between values to the
    next decisive state (reverse scan)."""
    open_mask = actions > 0.95
    closed_mask = actions < 0.05
    in_between = ~(open_mask | closed_mask)
    out = np.empty_like(actions, dtype=np.float32)
    carry = np.float32(actions[-1])
    for i in range(len(actions) - 1, -1, -1):
        if not in_between[i]:
            carry = np.float32(open_mask[i])
        out[i] = carry
    return out


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1 - actions


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative open/close impulses (+1 close, -1 open in raw data) ->
    absolute state in {0, 1} via forward hold-last-command scan."""
    opening = actions < -0.1
    closing = actions > 0.1
    thresholded = np.where(opening, 1, np.where(closing, -1, 0)).astype(np.int64)

    nz = np.nonzero(thresholded != 0)[0]
    first = thresholded[nz[0]] if len(nz) else 0
    start = -first if first != 0 else 1

    out = np.empty(len(actions), dtype=np.int64)
    carry = start
    for i in range(len(actions)):
        if thresholded[i] != 0:
            carry = thresholded[i]
        out[i] = carry
    return out.astype(np.float32) / 2 + 0.5


def relabel_bridge_actions(traj: Traj) -> Traj:
    """Movement actions from consecutive proprio states; drops the final
    (actionless) timestep."""
    movement = traj["observation"]["state"][1:, :6] - traj["observation"]["state"][:-1, :6]
    out = tree_map(lambda x: x[:-1], traj)
    out["action"] = np.concatenate([movement, traj["action"][:-1, -1:]], axis=1)
    return out


# ---------------------------------------------------------------------------
# goal relabeling / task augmentation
# ---------------------------------------------------------------------------

def uniform_goal_relabel(traj: Traj, rng: np.random.Generator) -> Traj:
    T = len(traj["action"])
    rand = rng.random(T)
    low = np.arange(T, dtype=np.float64) + 1
    goal_idx = np.minimum((rand * (T - low) + low).astype(np.int64), T - 1)
    goal = tree_map(lambda x: x[goal_idx], traj["observation"])
    traj["task"] = tree_merge(traj.get("task", {}), goal)
    return traj


def delete_task_conditioning(traj: Traj, keep_image_prob: float, rng: np.random.Generator) -> Traj:
    if "language_instruction" not in traj.get("task", {}):
        return traj
    image_keys = {
        k for k in traj["task"] if k.startswith("image_") or k.startswith("depth_")
    }
    if not image_keys:
        return traj
    T = len(traj["action"])
    keep_images = rng.random(T) < keep_image_prob
    keep_images |= ~traj["task"]["pad_mask_dict"]["language_instruction"]

    for key in image_keys | {"language_instruction"}:
        keep = keep_images if key in image_keys else ~keep_images
        v = traj["task"][key]
        traj["task"][key] = np.where(keep, v, to_padding(v))
        traj["task"]["pad_mask_dict"][key] = np.where(
            keep, traj["task"]["pad_mask_dict"][key], False
        )
    traj["task"]["timestep"] = np.where(keep_images, traj["task"]["timestep"], T - 1)
    return traj
