"""Spatial action tokenizer: continuous 7-DoF end-effector actions <->
discrete spatial action token ids.

Token-id layout (local ids, 0-based):
    [0, T)            translation (theta x phi x r spherical grid, T = 16*32*8)
    [T, T+R)          rotation (roll x pitch x yaw Euler grid, R = 16^3)
    [T+R, T+R+G)      gripper (G = 2)

Global token ids are ``local_id + token_begin_idx`` where
``token_begin_idx`` is where the <ACTIONxxxxx> block starts in the text
vocabulary.

Math parity with the reference repository's model/action_tokenizer.py:
  - encode clips the cartesian action to [min_action, max_action] first
    (:315), translation converts cartesian->spherical (:93-97) and uses
    interior-edge digitize ``np.digitize(x, bins[1:-1])`` (:115-117);
  - rotation uses ``clip(digitize(x, bins) - 1, 0, n-1)`` (:183-185)
    (NOTE: the two digitize conventions intentionally differ);
  - gripper thresholds at 0.5 (:232);
  - decode returns bin centers; spherical decode converts back to
    cartesian and clips to [-1, 1] (:130-137).

This implementation is pure NumPy and does not require a text tokenizer;
string forms use the '<ACTION{:05d}>' template (:12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .bin_policy import RANGE_BINS, make_bin_policy

ACTION_TOKEN = "<ACTION{:05d}>"

DEFAULT_NUM_BINS: Dict = {
    "translation": {"theta_bins": 16, "phi_bins": 32, "r_bins": 8},
    "rotation": {"roll_bins": 16, "pitch_bins": 16, "yaw_bins": 16},
    "gripper": 2,
}


def cartesian_to_spherical(x, y, z):
    # physics convention: theta measured from +z, phi in the xy-plane
    theta = np.arctan2(np.sqrt(x**2 + y**2), z)
    phi = np.arctan2(y, x)
    r = np.sqrt(x**2 + y**2 + z**2)
    return theta, phi, r


def spherical_to_cartesian(theta, phi, r):
    x = r * np.sin(theta) * np.cos(phi)
    y = r * np.sin(theta) * np.sin(phi)
    z = r * np.cos(theta)
    return x, y, z


class TranslationTokenizer:
    """(n, 3) cartesian translation -> (n,) local grid ids in [0, T)."""

    def __init__(self, num_bins: Dict, bin_policy: Dict, use_spherical: bool = True):
        self.num_theta = num_bins["theta_bins"]
        self.num_phi = num_bins["phi_bins"]
        self.num_r = num_bins["r_bins"]
        self.use_spherical = use_spherical
        self.NP = self.num_phi * self.num_r
        self.vocab_size = self.num_theta * self.num_phi * self.num_r
        self.set_bins(bin_policy)

    def set_bins(self, bin_policy: Dict):
        self.theta_bins = np.asarray(bin_policy["theta_bins"], dtype=np.float64)
        self.phi_bins = np.asarray(bin_policy["phi_bins"], dtype=np.float64)
        self.r_bins = np.asarray(bin_policy["r_bins"], dtype=np.float64)

    def encode(self, action: np.ndarray) -> np.ndarray:
        if self.use_spherical:
            theta, phi, r = cartesian_to_spherical(action[:, 0], action[:, 1], action[:, 2])
        else:
            theta, phi, r = action[:, 0], action[:, 1], action[:, 2]
        d_theta = np.digitize(theta, self.theta_bins[1:-1])
        d_phi = np.digitize(phi, self.phi_bins[1:-1])
        d_r = np.digitize(r, self.r_bins[1:-1])
        return d_theta * self.NP + d_phi * self.num_r + d_r

    def decode(self, ids: np.ndarray) -> np.ndarray:
        ids = np.clip(ids, 0, self.vocab_size - 1)
        d_theta = ids // self.NP
        d_phi = (ids % self.NP) // self.num_r
        d_r = ids % self.num_r
        theta = 0.5 * (self.theta_bins[d_theta] + self.theta_bins[d_theta + 1])
        phi = 0.5 * (self.phi_bins[d_phi] + self.phi_bins[d_phi + 1])
        r = 0.5 * (self.r_bins[d_r] + self.r_bins[d_r + 1])
        if self.use_spherical:
            x, y, z = spherical_to_cartesian(theta, phi, r)
        else:
            x, y, z = theta, phi, r
        x, y, z = np.clip([x, y, z], -1.0, 1.0)
        return np.stack((x, y, z), axis=1)


class RotationTokenizer:
    """(n, 3) Euler rotation -> (n,) local grid ids in [0, R)."""

    def __init__(self, num_bins: Dict, bin_policy: Dict):
        self.num_roll = num_bins["roll_bins"]
        self.num_pitch = num_bins["pitch_bins"]
        self.num_yaw = num_bins["yaw_bins"]
        self.NP = self.num_pitch * self.num_yaw
        self.vocab_size = self.num_roll * self.num_pitch * self.num_yaw
        self.set_bins(bin_policy)

    def set_bins(self, bin_policy: Dict):
        self.roll_bins = np.asarray(bin_policy["roll_bins"], dtype=np.float64)
        self.pitch_bins = np.asarray(bin_policy["pitch_bins"], dtype=np.float64)
        self.yaw_bins = np.asarray(bin_policy["yaw_bins"], dtype=np.float64)

    def encode(self, action: np.ndarray) -> np.ndarray:
        d_roll = np.clip(np.digitize(action[:, 0], self.roll_bins) - 1, 0, self.num_roll - 1)
        d_pitch = np.clip(np.digitize(action[:, 1], self.pitch_bins) - 1, 0, self.num_pitch - 1)
        d_yaw = np.clip(np.digitize(action[:, 2], self.yaw_bins) - 1, 0, self.num_yaw - 1)
        return d_roll * self.NP + d_pitch * self.num_yaw + d_yaw

    def decode(self, ids: np.ndarray) -> np.ndarray:
        ids = np.clip(ids, 0, self.vocab_size - 1)
        d_roll = ids // self.NP
        d_pitch = (ids % self.NP) // self.num_yaw
        d_yaw = ids % self.num_yaw
        roll = 0.5 * (self.roll_bins[d_roll] + self.roll_bins[d_roll + 1])
        pitch = 0.5 * (self.pitch_bins[d_pitch] + self.pitch_bins[d_pitch + 1])
        yaw = 0.5 * (self.yaw_bins[d_yaw] + self.yaw_bins[d_yaw + 1])
        return np.stack((roll, pitch, yaw), axis=1)


class GripperTokenizer:
    """(n,) gripper command -> (n,) local ids in [0, G)."""

    def __init__(self, num_bins: int = 2):
        self.vocab_size = num_bins

    def encode(self, action: np.ndarray) -> np.ndarray:
        return np.where(action >= 0.5, 1, 0)

    def decode(self, ids: np.ndarray) -> np.ndarray:
        ids = np.clip(ids, 0, self.vocab_size - 1)
        return np.where(ids == 0, 0.0, 1.0)[:, None]


@dataclass
class SpatialActionTokenizer:
    """Composite tokenizer over [translation][rotation][gripper] id blocks."""

    num_bins: Dict = None
    bin_policy: Dict = None
    gs_params: Optional[Dict] = None
    use_spherical: bool = True
    min_sigma: float = 0.0
    min_action: float = -1.0
    max_action: float = 1.0
    token_begin_idx: int = 0  # offset of the action block in the text vocab

    def __post_init__(self):
        if self.num_bins is None:
            self.num_bins = DEFAULT_NUM_BINS
        if self.bin_policy is None:
            self.bin_policy = make_bin_policy(self.num_bins, self.gs_params, self.min_sigma)
        self.translation = TranslationTokenizer(
            self.num_bins["translation"], self.bin_policy["translation"], self.use_spherical
        )
        self.rotation = RotationTokenizer(self.num_bins["rotation"], self.bin_policy["rotation"])
        self.gripper = GripperTokenizer(self.num_bins["gripper"])
        self.rotation_begin = self.translation.vocab_size
        self.gripper_begin = self.rotation_begin + self.rotation.vocab_size
        self.vocab_size = self.gripper_begin + self.gripper.vocab_size

    # -- encode ------------------------------------------------------------
    def encode(self, action: np.ndarray) -> np.ndarray:
        """(n, 7) or (7,) continuous action -> (n, 3) local token ids."""
        action = np.asarray(action, dtype=np.float64)
        if action.ndim == 1:
            action = action.reshape(1, -1)
        assert action.shape[1] == 7, f"expected (n, 7) actions, got {action.shape}"
        action = np.clip(action, self.min_action, self.max_action)
        t = self.translation.encode(action[:, :3])
        r = self.rotation.encode(action[:, 3:6]) + self.rotation_begin
        g = self.gripper.encode(action[:, 6]) + self.gripper_begin
        return np.stack((t, r, g), axis=1)

    def encode_to_global_ids(self, action: np.ndarray) -> np.ndarray:
        return self.encode(action) + self.token_begin_idx

    def encode_to_strings(self, action: np.ndarray) -> np.ndarray:
        """(n, 7) -> (n, 3) array of '<ACTIONxxxxx>' strings."""
        ids = self.encode(action)
        fmt = np.vectorize(lambda i: ACTION_TOKEN.format(i))
        return fmt(ids)

    # -- decode ------------------------------------------------------------
    def decode(self, local_ids: np.ndarray) -> np.ndarray:
        """(n, 3) or (3,) local token ids -> (n, 7) normalized actions."""
        local_ids = np.asarray(local_ids)
        if local_ids.ndim == 1:
            local_ids = local_ids.reshape(1, -1)
        assert local_ids.shape[1] == 3, f"expected (n, 3) ids, got {local_ids.shape}"
        t = self.translation.decode(local_ids[:, 0])
        r = self.rotation.decode(local_ids[:, 1] - self.rotation_begin)
        g = self.gripper.decode(local_ids[:, 2] - self.gripper_begin)
        return np.concatenate((t, r, g), axis=1)

    def decode_global_ids(self, token_ids: np.ndarray) -> np.ndarray:
        return self.decode(np.asarray(token_ids) - self.token_begin_idx)

    # -- adaptation ----------------------------------------------------------
    def adapt_to_gaussian(self, gs_params: Dict, min_sigma: float = 0.0,
                          embeddings: Optional[np.ndarray] = None):
        """Re-fit the bin policy to new Gaussian stats; optionally re-grid a
        spatial embedding table to the new grid (returns the new table)."""
        from .bin_policy import adapt_spatial_embeddings, gaussian_bin_policy

        new_policy = gaussian_bin_policy(self.num_bins, gs_params, min_sigma)
        new_emb = None
        if embeddings is not None:
            new_emb = adapt_spatial_embeddings(embeddings, self.num_bins, self.bin_policy, new_policy)
        self.bin_policy = new_policy
        self.gs_params = gs_params  # keep persisted artifacts in sync
        self.min_sigma = min_sigma
        self.translation.set_bins(new_policy["translation"])
        self.rotation.set_bins(new_policy["rotation"])
        return new_emb


class UniformActionTokenizer:
    """Legacy OpenVLA-style per-dimension uniform binning
    (reference: ActionTokenizer, action_tokenizer.py:14-57): each of the 7
    action dims is digitized independently onto ``num_bins`` uniformly
    spaced bin centers, costing 7 tokens per action step."""

    def __init__(self, num_bins: int = 256, min_action: float = -1.0,
                 max_action: float = 1.0, token_begin_idx: int = 0):
        self.vocab_size = num_bins
        self.min_action, self.max_action = min_action, max_action
        self.bin_centers = np.linspace(min_action, max_action, num_bins)
        self.token_begin_idx = token_begin_idx

    def encode(self, action: np.ndarray) -> np.ndarray:
        action = np.clip(action, self.min_action, self.max_action)
        return np.digitize(action, self.bin_centers, right=True)

    def decode(self, local_ids: np.ndarray) -> np.ndarray:
        ids = np.clip(local_ids, 0, self.vocab_size - 1)
        return self.bin_centers[ids]
