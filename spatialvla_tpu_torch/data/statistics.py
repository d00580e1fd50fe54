"""Per-dataset action/proprio statistics with on-disk caching.

Reference behavior (data/utils/data_utils.py:244-362): a full pass over the
dataset accumulates action and proprio vectors; statistics are
mean/std/min/max/q01/q99 plus transition/trajectory counts, cached under a
hash of the dataset identity + transform so the pass runs once; a
`save_dataset_statistics` writes the merged ds_stats.json next to training
output for the processor's unnormalization table.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

_CACHE_DIR = os.path.expanduser("~/.cache/spatialvla_tpu_torch/dataset_statistics")


def array_stats(arr: np.ndarray) -> Dict[str, Any]:
    return {
        "mean": arr.mean(0).tolist(),
        "std": arr.std(0).tolist(),
        "max": arr.max(0).tolist(),
        "min": arr.min(0).tolist(),
        "q01": np.quantile(arr, 0.01, axis=0).tolist(),
        "q99": np.quantile(arr, 0.99, axis=0).tolist(),
    }


def cache_key(dataset_name: str, state_obs_keys, transform_name: str) -> str:
    h = hashlib.sha256()
    h.update(dataset_name.encode())
    h.update(json.dumps(list(state_obs_keys)).encode())
    h.update(transform_name.encode())
    return h.hexdigest()


def compute_dataset_statistics(
    episodes: Iterable[Dict[str, Any]],
    *,
    dataset_name: str,
    state_obs_keys=(),
    transform_name: str = "",
    cache_dir: Optional[str] = None,
    force: bool = False,
) -> Dict[str, Any]:
    """episodes: iterator of canonical trajs (after standardize+restructure,
    before normalization). Returns the reference-format statistics dict."""
    cache_dir = cache_dir or _CACHE_DIR
    key = cache_key(dataset_name, state_obs_keys, transform_name)
    cache_path = os.path.join(cache_dir, f"{key}.json")
    if not force and os.path.exists(cache_path):
        with open(cache_path) as f:
            return json.load(f)

    actions, proprios = [], []
    n_traj = 0
    n_trans = 0
    for traj in episodes:
        n_traj += 1
        a = np.asarray(traj["action"], dtype=np.float32)
        n_trans += len(a)
        actions.append(a)
        p = traj.get("observation", {}).get("proprio")
        if p is not None:
            proprios.append(np.asarray(p, dtype=np.float32))

    if n_traj == 0:
        raise ValueError(f"{dataset_name}: no episodes found")
    out: Dict[str, Any] = {
        "action": array_stats(np.concatenate(actions)),
        "num_transitions": int(n_trans),
        "num_trajectories": int(n_traj),
    }
    if proprios:
        out["proprio"] = array_stats(np.concatenate(proprios))
    else:
        # the reference always emits a proprio block (zeros_like(action)
        # substitute, data_utils.py:283-329) so ds_stats.json artifacts are
        # schema-identical regardless of the dataset's proprio coverage
        out["proprio"] = array_stats(np.zeros_like(np.concatenate(actions)))

    os.makedirs(cache_dir, exist_ok=True)
    with open(cache_path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def save_dataset_statistics(stats_by_dataset: Dict[str, Dict], path: str) -> Dict:
    """Merged ds_stats.json (the unnormalization table shipped with
    checkpoints, data_utils.py:345-362)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(stats_by_dataset, f, indent=2)
    return stats_by_dataset


def fit_gaussian_params(actions: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Fit the per-dimension Gaussians used by the adaptive bin policy
    (the gs_*.json artifacts): translation in spherical (theta, phi, r),
    rotation in normalized Euler dims."""
    from ..action.tokenizer import cartesian_to_spherical

    a = np.asarray(actions, dtype=np.float64)
    a = np.clip(a, -1, 1)
    out = {}
    for i, name in enumerate(["x", "y", "z"]):
        out[name] = {"mu": float(a[:, i].mean()), "sigma": float(a[:, i].std())}
    theta, phi, r = cartesian_to_spherical(a[:, 0], a[:, 1], a[:, 2])
    for name, v in (("theta", theta), ("phi", phi), ("r", r)):
        out[name] = {"mu": float(v.mean()), "sigma": float(v.std())}
    for i, name in enumerate(["roll", "pitch", "yaw"]):
        v = a[:, 3 + i]
        out[name] = {"mu": float(v.mean()), "sigma": float(v.std())}
    return out
