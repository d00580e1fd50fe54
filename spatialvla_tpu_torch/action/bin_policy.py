"""Adaptive action-grid bin policies.

Bin boundaries are placed at equal probability mass under a per-dataset
Gaussian fit of the (spherical-translation / Euler-rotation) action
distribution, matching the reference math
(the reference repository's model/action_tokenizer.py:343-370): boundaries are
``norm.ppf(linspace(cdf(lo), cdf(hi), n+1))`` clipped to the dimension's
range, with a ``min_sigma`` floor on sigma.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
from scipy.stats import norm

# canonical per-dimension ranges (action_tokenizer.py:250-261)
RANGE_BINS: Dict[str, Dict[str, tuple]] = {
    "translation": {
        "theta_bins": (0.0, float(np.pi)),
        "phi_bins": (-float(np.pi), float(np.pi)),
        "r_bins": (0.0, float(np.sqrt(3.0))),
    },
    "rotation": {
        "roll_bins": (-1.0, 1.0),
        "pitch_bins": (-1.0, 1.0),
        "yaw_bins": (-1.0, 1.0),
    },
}


def uniform_bin_policy(num_bins: Dict) -> Dict:
    """Uniform grid boundaries over the canonical ranges."""
    policy = {}
    for bin_type, dims in RANGE_BINS.items():
        policy[bin_type] = {}
        for bin_key, (lo, hi) in dims.items():
            n = num_bins[bin_type][bin_key]
            policy[bin_type][bin_key] = np.linspace(lo, hi, n + 1).tolist()
    return policy


def gaussian_bin_policy(num_bins: Dict, gs_params: Dict, min_sigma: float = 0.0) -> Dict:
    """Equal-probability-mass boundaries under per-dim Gaussian statistics.

    gs_params maps dim name ('theta','phi','r','roll','pitch','yaw') to
    {'mu': float, 'sigma': float} (the gs_*.json files of the reference).
    """
    policy = {}
    for bin_type, dims in RANGE_BINS.items():
        policy[bin_type] = {}
        for bin_key, (lo, hi) in dims.items():
            dim = bin_key.split("_")[0].lower()
            mu = gs_params[dim]["mu"]
            sigma = max(gs_params[dim]["sigma"], min_sigma)
            n = num_bins[bin_type][bin_key]
            probs = np.linspace(
                norm.cdf(lo, loc=mu, scale=sigma),
                norm.cdf(hi, loc=mu, scale=sigma),
                n + 1,
            )
            boundary = norm.ppf(probs, loc=mu, scale=sigma)
            policy[bin_type][bin_key] = np.clip(boundary, lo, hi).tolist()
    return policy


def make_bin_policy(
    num_bins: Dict,
    gs_params: Optional[Dict] = None,
    min_sigma: float = 0.0,
) -> Dict:
    if gs_params is None:
        return uniform_bin_policy(num_bins)
    return gaussian_bin_policy(num_bins, gs_params, min_sigma)


def load_gs_params(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def norm_meshgrid(bin_policy: Dict):
    """Normalized bin-center meshgrids (with replicated-edge padding rows)
    for trilinear embedding re-gridding.

    Mirrors get_norm_meshgrid (action_tokenizer.py:372-388) but uses
    'ij' indexing so grid-point ordering matches the row-major
    (theta, phi, r) flattening of the embedding table for non-cubic grids
    (the reference's 'xy' meshgrid ordering only coincides for m == n).
    """
    grids = []
    for bin_type in RANGE_BINS.keys():
        centers = []
        for bin_key in RANGE_BINS[bin_type].keys():
            lo, hi = RANGE_BINS[bin_type][bin_key]
            boundary = np.asarray(bin_policy[bin_type][bin_key])
            center = 0.5 * (boundary[:-1] + boundary[1:])
            center = np.concatenate([[lo], center, [hi]])  # pad with range ends
            center = (center - lo) / (hi - lo)
            centers.append(center)
        gx, gy, gz = np.meshgrid(*centers, indexing="ij")
        grids.append(np.stack([gx, gy, gz], -1).reshape(-1, 3))
    return grids[0], grids[1]


def adapt_spatial_embeddings(
    embeddings: np.ndarray,
    num_bins: Dict,
    old_policy: Dict,
    new_policy: Dict,
) -> np.ndarray:
    """Re-grid the learned spatial-token embedding table onto a new bin
    policy by trilinear interpolation over the normalized 3D bin-center
    grids (reference: spatial_embedding_adaption,
    action_tokenizer.py:390-431).

    embeddings: (S, E) with layout [translation N][rotation M][gripper ...].
    Returns a new (S, E) array; gripper rows (and any tail) are unchanged.
    """
    from scipy.interpolate import griddata

    emb = np.asarray(embeddings, dtype=np.float32)
    out = emb.copy()
    E = emb.shape[1]

    tgrid0, rgrid0 = norm_meshgrid(old_policy)
    tgrid1, rgrid1 = norm_meshgrid(new_policy)

    def _regrid(table: np.ndarray, dims, grid0, grid1):
        m, n, k = dims
        vol = table.reshape(m, n, k, E)
        # replicate-pad each spatial axis by 1 (matches F.pad 'replicate')
        vol = np.pad(vol, ((1, 1), (1, 1), (1, 1), (0, 0)), mode="edge")
        flat = vol.reshape(-1, E)
        new = griddata(grid0, flat, grid1, method="linear")
        # points outside the old grid's convex hull -> nearest fallback
        nan_rows = np.isnan(new).any(axis=1)
        if nan_rows.any():
            near = griddata(grid0, flat, grid1[nan_rows], method="nearest")
            new[nan_rows] = near
        new = new.reshape(m + 2, n + 2, k + 2, E)[1:-1, 1:-1, 1:-1]
        return new.reshape(-1, E)

    tb = num_bins["translation"]
    rb = num_bins["rotation"]
    tdims = (tb["theta_bins"], tb["phi_bins"], tb["r_bins"])
    rdims = (rb["roll_bins"], rb["pitch_bins"], rb["yaw_bins"])
    N = int(np.prod(tdims))
    M = int(np.prod(rdims))

    out[:N] = _regrid(emb[:N], tdims, tgrid0, tgrid1)
    out[N : N + M] = _regrid(emb[N : N + M], rdims, rgrid0, rgrid1)
    return out
