"""Closed-loop evaluation adapters.

The reference evaluates through a SimplerEnv fork and LIBERO out-of-repo
(README.md:154-161, SURVEY.md §4); these adapters expose this framework's
policy through the interfaces those harnesses expect, so the sims plug in
unchanged. Simulators are optional dependencies — the adapters are pure
glue and unit-testable without them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def euler_to_axis_angle(euler: np.ndarray) -> np.ndarray:
    """(roll, pitch, yaw) -> axis-angle 3-vector (SimplerEnv's rot format)."""
    roll, pitch, yaw = euler
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    qw = cr * cp * cy + sr * sp * sy
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    angle = 2 * np.arccos(np.clip(qw, -1.0, 1.0))
    s = np.sqrt(max(1 - qw * qw, 1e-12))
    axis = np.array([qx, qy, qz]) / s if s > 1e-6 else np.array([1.0, 0.0, 0.0])
    return axis * angle


class SimplerEnvPolicyAdapter:
    """Implements the SimplerEnv policy interface:
        reset(task_description); step(image, task_description) ->
        (raw_action, action) where action has world_vector / rot_axangle /
        gripper / terminate_episode.

    Includes the standard WidowX/Google-robot gripper conventions:
    'bridge' maps [0,1] open-fraction to the env's +-1 continuous command;
    'google_robot' uses sticky gripper emulation (the policy emits absolute
    open/close, the robot expects relative commands)."""

    def __init__(
        self,
        policy,
        *,
        unnorm_key: Optional[str] = None,
        policy_setup: str = "widowx_bridge",
        sticky_steps: int = 15,
        action_scale: float = 1.0,
    ):
        self.policy = policy
        self.unnorm_key = unnorm_key
        self.policy_setup = policy_setup
        self.sticky_steps = sticky_steps
        self.action_scale = action_scale
        self._chunk: list = []
        self.reset("")

    def reset(self, task_description: str):
        self.task_description = task_description
        self._chunk = []
        # sticky-gripper state (google robot)
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        self.previous_gripper_action = None

    def _next_action(self, image) -> np.ndarray:
        if not self._chunk:
            out = self.policy.predict(
                image, self.task_description, unnorm_key=self.unnorm_key
            )
            self._chunk = list(np.asarray(out["actions"], dtype=np.float64))
        return self._chunk.pop(0)

    def step(self, image, task_description: Optional[str] = None):
        if task_description is not None and task_description != self.task_description:
            self.reset(task_description)

        raw = self._next_action(image)  # (7,): dxyz, drpy, gripper in [0,1]
        action: Dict[str, np.ndarray] = {
            "world_vector": raw[:3] * self.action_scale,
            "rot_axangle": euler_to_axis_angle(raw[3:6]) * self.action_scale,
        }

        g = float(raw[6])
        if self.policy_setup == "google_robot":
            # absolute [0,1] -> relative with sticky emulation
            current = 2.0 * (g > 0.5) - 1.0  # {-1, 1}
            if self.previous_gripper_action is None:
                rel = 0.0
            else:
                rel = self.previous_gripper_action - current  # close=+, open=-
            self.previous_gripper_action = current
            if abs(rel) > 0.5 and not self.sticky_action_is_on:
                self.sticky_action_is_on = True
                self.sticky_gripper_action = rel
            if self.sticky_action_is_on:
                self.gripper_action_repeat += 1
                rel = self.sticky_gripper_action
                if self.gripper_action_repeat == self.sticky_steps:
                    self.sticky_action_is_on = False
                    self.gripper_action_repeat = 0
                    self.sticky_gripper_action = 0.0
            action["gripper"] = np.array([rel])
        else:  # widowx_bridge: [0,1] open fraction -> {-1, +1}
            action["gripper"] = np.array([2.0 * (g > 0.5) - 1.0])

        action["terminate_episode"] = np.array([0.0])
        return raw, action


class LiberoPolicyAdapter:
    """LIBERO expects a 7-dim action: (dx, dy, dz, droll, dpitch, dyaw,
    gripper in {-1 open, +1 close})."""

    def __init__(self, policy, *, unnorm_key: Optional[str] = None):
        self.policy = policy
        self.unnorm_key = unnorm_key
        self._chunk: list = []

    def reset(self):
        self._chunk = []

    def step(self, image, task_description: str) -> np.ndarray:
        if not self._chunk:
            out = self.policy.predict(image, task_description, unnorm_key=self.unnorm_key)
            self._chunk = list(np.asarray(out["actions"], dtype=np.float64))
        raw = self._chunk.pop(0)
        gripper = -1.0 if raw[6] > 0.5 else 1.0  # policy: 1=open; libero: -1=open
        return np.concatenate([raw[:6], [gripper]])


def run_simpler_env(env, adapter: SimplerEnvPolicyAdapter, max_steps: int = 120):
    """Minimal closed-loop episode driver for a SimplerEnv gym env. Returns
    (success, n_steps). Thin compatibility wrapper over the eval driver's
    episode loop (eval/driver.py:run_episode — one copy of the step/
    termination/success semantics)."""
    from .driver import run_episode

    ep = run_episode(env, adapter, max_steps=max_steps)
    return ep["success"], ep["steps"]
