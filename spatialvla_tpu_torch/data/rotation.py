"""Rotation algebra for dataset standardization, pure NumPy.

Replaces the reference's tensorflow_graphics dependency
(data/oxe/transforms.py:972-987, data/utils/droid_utils.py:5). Euler
convention follows tfg: angles (roll, pitch, yaw) = rotations about x, y, z
with R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
"""
from __future__ import annotations

import numpy as np


def quaternion_from_axis_angle(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """axis (..., 3) unit, angle (..., 1) -> quaternion (..., 4) [x, y, z, w]."""
    half = 0.5 * angle
    return np.concatenate([axis * np.sin(half), np.cos(half)], axis=-1)


def euler_from_quaternion(q: np.ndarray) -> np.ndarray:
    """q (..., 4) [x, y, z, w] -> (..., 3) (roll, pitch, yaw)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def euler_from_axis_angle(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """axis (..., 3), angle (..., 1) -> (..., 3) Euler angles."""
    return euler_from_quaternion(quaternion_from_axis_angle(axis, angle))


def rmat_from_euler(euler: np.ndarray) -> np.ndarray:
    """(..., 3) (roll, pitch, yaw) -> (..., 3, 3)."""
    r, p, y = euler[..., 0], euler[..., 1], euler[..., 2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    R = np.empty(euler.shape[:-1] + (3, 3), dtype=euler.dtype)
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def euler_from_rmat(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) (roll, pitch, yaw); gimbal-safe clamp."""
    pitch = np.arcsin(np.clip(-R[..., 2, 0], -1.0, 1.0))
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    return np.stack([roll, pitch, yaw], axis=-1)


def rmat_from_r6(r6: np.ndarray) -> np.ndarray:
    """Zhou et al. 6D rotation representation (..., 6) -> (..., 3, 3) via
    Gram-Schmidt on the two column vectors."""
    a1, a2 = r6[..., :3], r6[..., 3:6]
    b1 = a1 / (np.linalg.norm(a1, axis=-1, keepdims=True) + 1e-8)
    a2p = a2 - np.sum(b1 * a2, axis=-1, keepdims=True) * b1
    b2 = a2p / (np.linalg.norm(a2p, axis=-1, keepdims=True) + 1e-8)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-1)


def euler_from_r6(r6: np.ndarray) -> np.ndarray:
    return euler_from_rmat(rmat_from_r6(r6))
