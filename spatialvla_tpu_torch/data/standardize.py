"""Per-dataset standardization: raw decoded RLDS episodes -> canonical
{observation{...}, action (T, 7), language_instruction}.

NumPy re-expression of the reference's TF standardize functions
(data/oxe/transforms.py — behavior cited per function). Each function takes
the nested episode dict produced by tfds_schema.decode_episode (the raw
per-dataset schema) and rewrites it in place. Encoded images stay as
byte-lists throughout (decode happens in the frame pipeline).
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Dict

import numpy as np

from .rotation import euler_from_axis_angle, euler_from_quaternion
from .transforms import (
    binarize_gripper_actions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
    relabel_bridge_actions,
    tree_map,
)

Traj = Dict[str, Any]


def _drop_first(traj: Traj) -> Traj:
    """Drop timestep 0 everywhere (bridge's first action is all-zero)."""

    def cut(x):
        return x[1:]

    out = {}
    for k, v in traj.items():
        if k == "traj_metadata":
            out[k] = v
        elif isinstance(v, dict):
            out[k] = tree_map(cut, v)
        else:
            out[k] = cut(v)
    return out


def _cat(*parts) -> np.ndarray:
    return np.concatenate([np.asarray(p, dtype=np.float32) for p in parts], axis=-1)


def _clip01(x):
    return np.clip(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# transforms (reference file:line cited per function)
# ---------------------------------------------------------------------------

def bridge_orig(traj: Traj) -> Traj:
    """transforms.py:65-92: drop t=0, binarize gripper, relabel actions
    from reached state, split EEF/gripper state."""
    traj = _drop_first(traj)
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], binarize_gripper_actions(a[:, -1])[:, None])
    traj = relabel_bridge_actions(traj)
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["EEF_state"] = state[:, :6]
    traj["observation"]["gripper_state"] = state[:, -1:]
    return traj


def rt1(traj: Traj) -> Traj:
    """transforms.py:112-130 (fractal20220817_data): rel->abs gripper."""
    act = traj["action"]
    grip = rel2abs_gripper_actions(np.asarray(act["gripper_closedness_action"])[:, 0])
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def kuka(traj: Traj) -> Traj:
    """transforms.py:132-165: rel->abs gripper + ZLIB-compressed state."""
    act = traj["action"]
    grip = rel2abs_gripper_actions(np.asarray(act["gripper_closedness_action"])[:, 0])
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    obs = traj["observation"]
    key = "clip_function_input/base_pose_tool_reached"
    if key in obs and isinstance(obs[key], list):
        obs[key] = np.stack([
            np.frombuffer(zlib.decompress(b), dtype=np.float32) for b in obs[key]
        ]).reshape(-1, 7)
    if "gripper_closed" in obs and isinstance(obs["gripper_closed"], list):
        obs["gripper_closed"] = np.stack([
            np.frombuffer(zlib.decompress(b), dtype=np.float32)
            for b in obs["gripper_closed"]
        ]).reshape(-1, 1)
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def taco_play(traj: Traj) -> Traj:
    obs = traj["observation"]
    robs = np.asarray(obs["robot_obs"], dtype=np.float32)
    obs["state_eef"] = robs[:, :6]
    obs["state_gripper"] = robs[:, 7:8]
    a = np.asarray(traj["action"]["rel_actions_world"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], _clip01(a[:, -1:]))
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def jaco_play(traj: Traj) -> Traj:
    obs = traj["observation"]
    eef = np.asarray(obs["end_effector_cartesian_pos"], dtype=np.float32)
    obs["state_eef"] = eef[:, :6]
    obs["state_gripper"] = eef[:, -1:]
    act = traj["action"]
    grip = rel2abs_gripper_actions(np.asarray(act["gripper_closedness_action"])[:, 0])
    wv = np.asarray(act["world_vector"], dtype=np.float32)
    traj["action"] = _cat(wv, np.zeros_like(wv), grip[:, None])
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def berkeley_cable_routing(traj: Traj) -> Traj:
    act = traj["action"]
    wv = np.asarray(act["world_vector"], dtype=np.float32)
    traj["action"] = _cat(wv, act["rotation_delta"], np.zeros_like(wv[:, :1]))
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def roboturk(traj: Traj) -> Traj:
    act = traj["action"]
    grip = invert_gripper_actions(
        _clip01(np.asarray(act["gripper_closedness_action"], dtype=np.float32))
    )
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip)
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def viola(traj: Traj) -> Traj:
    act = traj["action"]
    grip = invert_gripper_actions(
        _clip01(np.asarray(act["gripper_closedness_action"], dtype=np.float32)[:, None])
    )
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip)
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def berkeley_autolab_ur5(traj: Traj) -> Traj:
    obs = traj["observation"]
    obs["state"] = np.asarray(obs["robot_state"], dtype=np.float32)[:, 6:14]
    if "image_with_depth" in obs:
        obs["depth"] = obs.pop("image_with_depth")
    act = traj["action"]
    grip = rel2abs_gripper_actions(np.asarray(act["gripper_closedness_action"]).reshape(-1))
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def toto(traj: Traj) -> Traj:
    act = traj["action"]
    traj["action"] = _cat(
        act["world_vector"], act["rotation_delta"],
        np.asarray(act["open_gripper"], dtype=np.float32)[:, None],
    )
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def language_table(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a), np.ones_like(a[:, :1]))
    # instruction is a padded unicode codepoint tensor
    inst = np.asarray(traj["observation"]["instruction"])
    decoded = []
    for row in inst:
        chars = [chr(c) for c in row if c != 0]
        decoded.append("".join(chars).encode("utf-8"))
    traj["language_instruction"] = decoded
    return traj


def stanford_hydra(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], invert_gripper_actions(a[:, -1:]))
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["eef_state"] = _cat(state[:, :3], state[:, 7:10])
    traj["observation"]["gripper_state"] = state[:, -3:-2]
    return traj


def austin_buds(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], invert_gripper_actions(_clip01(a[:, -1:])))
    traj["observation"]["state"] = np.asarray(
        traj["observation"]["state"], dtype=np.float32
    )[:, :8]
    return traj


def nyu_franka_play(traj: Traj) -> Traj:
    obs = traj["observation"]
    for k in ("depth", "depth_additional_view"):
        if k in obs:
            obs[k] = np.asarray(obs[k], dtype=np.float32)[..., 0]
    state = np.asarray(obs["state"], dtype=np.float32)
    obs["eef_state"] = state[:, -6:]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, -8:-2], _clip01(a[:, -2:-1]))
    return traj


def furniture_bench(traj: Traj) -> Traj:
    obs = traj["observation"]
    state = np.asarray(obs["state"], dtype=np.float32)
    obs["state"] = _cat(state[:, :7], state[:, -1:])
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(
        a[:, :3], euler_from_quaternion(a[:, 3:7]),
        invert_gripper_actions(_clip01(a[:, -1:])),
    )
    return traj


def ucsd_kitchen(traj: Traj) -> Traj:
    traj["observation"]["joint_state"] = np.asarray(
        traj["observation"]["state"], dtype=np.float32
    )[:, :7]
    traj["action"] = np.asarray(traj["action"], dtype=np.float32)[..., :-1]
    return traj


def austin_sailor_sirius(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], invert_gripper_actions(_clip01(a[:, -1:])))
    return traj


def dlr_edan(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], invert_gripper_actions(a[:, -1:]))
    return traj


def iamlab_cmu(traj: Traj) -> Traj:
    obs = traj["observation"]
    state = np.asarray(obs["state"], dtype=np.float32)
    obs["joint_state"] = state[:, :7]
    obs["gripper_state"] = state[:, 7:8]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :3], euler_from_quaternion(a[:, 3:7]), a[:, 7:8])
    return traj


def utaustin_mutex(traj: Traj) -> Traj:
    traj["observation"]["state"] = np.asarray(
        traj["observation"]["state"], dtype=np.float32
    )[:, :8]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], invert_gripper_actions(_clip01(a[:, -1:])))
    return traj


def berkeley_fanuc(traj: Traj) -> Traj:
    obs = traj["observation"]
    state = np.asarray(obs["state"], dtype=np.float32)
    obs["joint_state"] = state[:, :6]
    obs["gripper_state"] = state[:, 6:7]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a, invert_gripper_actions(obs["gripper_state"]))
    return traj


def cmu_stretch(traj: Traj) -> Traj:
    obs = traj["observation"]
    state = np.asarray(obs["state"], dtype=np.float32)
    obs["eef_state"] = _cat(state[:, :3], np.zeros_like(state[:, :3]))
    obs["gripper_state"] = state[:, -1:]
    traj["action"] = np.asarray(traj["action"], dtype=np.float32)[..., :-1]
    return traj


def bc_z(traj: Traj) -> Traj:
    act = traj["action"]
    traj["action"] = _cat(
        np.asarray(act["future/xyz_residual"], dtype=np.float32)[:, :3],
        np.asarray(act["future/axis_angle_residual"], dtype=np.float32)[:, :3],
        invert_gripper_actions(
            np.asarray(act["future/target_close"], dtype=np.float32)[:, :1]
        ),
    )
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def fmb(traj: Traj) -> Traj:
    obs = traj["observation"]
    traj["observation"]["proprio"] = _cat(
        obs["eef_pose"], np.asarray(obs["state_gripper_pose"], dtype=np.float32)[..., None]
    )
    return traj


def dobbe(traj: Traj) -> Traj:
    traj["observation"]["proprio"] = np.asarray(
        traj["observation"]["state"], dtype=np.float32
    )
    return traj


def droid_baseact(traj: Traj, rng: np.random.Generator = None) -> Traj:
    """droid_utils.py: cartesian base-frame velocity actions, inverted
    gripper, random exterior-camera swap, proprio from cartesian pose."""
    act = traj["action_dict"]
    vel = np.asarray(act["cartesian_velocity"], dtype=np.float32)
    grip = 1 - np.asarray(act["gripper_position"], dtype=np.float32)
    traj["action"] = _cat(vel[:, :3], vel[:, 3:6], grip)
    obs = traj["observation"]
    if rng is not None and rng.random() < 0.5:
        obs["exterior_image_1_left"], obs["exterior_image_2_left"] = (
            obs["exterior_image_2_left"], obs["exterior_image_1_left"],
        )
    obs["proprio"] = _cat(obs["cartesian_position"], obs["gripper_position"])
    return traj


def rh20t(traj: Traj) -> Traj:
    act = traj["action"]
    traj["action"] = _cat(
        act["tcp_base"], np.asarray(act["gripper"], dtype=np.float32)[:, None]
    )
    obs = traj["observation"]
    obs["proprio"] = _cat(
        obs["tcp_base"], np.asarray(obs["gripper_width"], dtype=np.float32)[..., None]
    )
    return traj


def uiuc_d3field(traj: Traj) -> Traj:
    """transforms.py:770-779: position-only actions padded to 7D."""
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a[:, :1]))
    return traj


def libero(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], invert_gripper_actions(_clip01(a[:, -1:])))
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["EEF_state"] = state[:, :6]
    traj["observation"]["gripper_state"] = state[:, -2:]
    return traj


def spatialvla_axis_angle(traj: Traj) -> Traj:
    """transforms.py:969-987: axis-angle rotation -> Euler, inverted
    clipped gripper."""
    a = np.asarray(traj["action"], dtype=np.float32)
    angle = np.linalg.norm(a[:, 3:6], axis=-1, keepdims=True)
    axis = a[:, 3:6] / (angle + 1e-6)
    traj["action"] = _cat(
        a[:, :3], euler_from_axis_angle(axis, angle),
        invert_gripper_actions(_clip01(a[:, -1:])),
    )
    return traj


def identity(traj: Traj) -> Traj:
    return traj


def bridge_oxe(traj: Traj) -> Traj:
    """OXE-bucket Bridge variant: drop t=0, assemble action from the
    world_vector/rotation_delta/open_gripper dict, relabel from state."""
    traj = _drop_first(traj)
    act = traj["action"]
    traj["action"] = _cat(
        act["world_vector"], act["rotation_delta"],
        np.asarray(act["open_gripper"], dtype=np.float32)[:, None],
    )
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    traj = relabel_bridge_actions(traj)
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["EEF_state"] = state[:, :6]
    traj["observation"]["gripper_state"] = state[:, -1:]
    return traj


def nyu_door_opening(traj: Traj) -> Traj:
    act = traj["action"]
    grip = rel2abs_gripper_actions(np.asarray(act["gripper_closedness_action"])[:, 0])
    traj["action"] = _cat(act["world_vector"], act["rotation_delta"], grip[:, None])
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def pusht(traj: Traj) -> Traj:
    act = traj["action"]
    traj["action"] = _cat(
        act["world_vector"], act["rotation_delta"],
        np.asarray(act["gripper_closedness_action"], dtype=np.float32)[:, None],
    )
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def stanford_kuka_multimodal(traj: Traj) -> Traj:
    obs = traj["observation"]
    if "depth_image" in obs and not isinstance(obs["depth_image"], list):
        obs["depth_image"] = np.asarray(obs["depth_image"])[..., 0]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:])
    return traj


def eef_gripper_state_split(traj: Traj) -> Traj:
    """Common pattern: observation.state = [eef(6), ..., gripper(1)]."""
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["eef_state"] = state[:, :6]
    traj["observation"]["gripper_state"] = state[:, -1:]
    return traj


def nyu_rot(traj: Traj) -> Traj:
    traj = eef_gripper_state_split(traj)
    traj["action"] = np.asarray(traj["action"], dtype=np.float32)[..., :7]
    return traj


def maniskill(traj: Traj) -> Traj:
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["gripper_state"] = state[..., 7:8]
    return traj


def cmu_franka_exploration(traj: Traj) -> Traj:
    traj["action"] = np.asarray(traj["action"], dtype=np.float32)[..., :-1]
    return traj


def ucsd_pick_place(traj: Traj) -> Traj:
    traj = eef_gripper_state_split(traj)
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:])
    return traj


def tokyo_pr2(traj: Traj) -> Traj:
    traj = eef_gripper_state_split(traj)
    traj["action"] = np.asarray(traj["action"], dtype=np.float32)[..., :-1]
    return traj


def utokyo_xarm_pick_place(traj: Traj) -> Traj:
    return traj


def utokyo_xarm_bimanual(traj: Traj) -> Traj:
    traj["action"] = np.asarray(traj["action"], dtype=np.float32)[..., -7:]
    return traj


def robo_net(traj: Traj) -> Traj:
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["eef_state"] = _cat(state[:, :4], np.zeros_like(state[:, :2]))
    traj["observation"]["gripper_state"] = state[:, -1:]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:])
    return traj


def kaist_nonprehensile(traj: Traj) -> Traj:
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["state"] = state[:, -7:]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], np.zeros_like(a[:, :1]))
    return traj


def stanford_mask_vit(traj: Traj) -> Traj:
    eef = np.asarray(traj["observation"]["end_effector_pose"], dtype=np.float32)
    traj["observation"]["eef_state"] = _cat(eef[:, :4], np.zeros_like(eef[:, :2]))
    traj["observation"]["gripper_state"] = eef[:, -1:]
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:])
    return traj


def dlr_sara_pour(traj: Traj) -> Traj:
    return traj


def dlr_sara_grid_clamp(traj: Traj) -> Traj:
    traj["observation"]["state"] = np.asarray(
        traj["observation"]["state"], dtype=np.float32
    )[:, :6]
    return traj


def asu_table_top(traj: Traj) -> Traj:
    if "ground_truth_states" in traj and "EE" in traj["ground_truth_states"]:
        traj["observation"]["eef_state"] = np.asarray(
            traj["ground_truth_states"]["EE"], dtype=np.float32
        )
    state = np.asarray(traj["observation"]["state"], dtype=np.float32)
    traj["observation"]["gripper_state"] = state[:, -1:]
    return traj


def robocook(traj: Traj) -> Traj:
    return eef_gripper_state_split(traj)


def imperial_wristcam(traj: Traj) -> Traj:
    traj["action"] = np.asarray(traj["action"], dtype=np.float32)[..., :-1]
    return traj


def cmu_playing_with_food(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :3], euler_from_quaternion(a[:, 3:7]), a[:, -1:])
    return traj


def playfusion(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :3], a[:, -4:])
    return traj


def gnm(traj: Traj) -> Traj:
    obs = traj["observation"]
    state = np.asarray(obs["state"], dtype=np.float32)
    obs["state"] = _cat(
        obs["position"], np.zeros_like(state[:, :3]), obs["yaw"]
    )
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a), np.zeros_like(a[:, :1]))
    return traj


def tdroid(traj: Traj) -> Traj:
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], binarize_gripper_actions(a[:, -1])[:, None])
    obs = traj["observation"]
    obs["EEF_state"] = np.asarray(obs["cartesian_position"], dtype=np.float32)[:, :6]
    obs["gripper_state"] = np.asarray(obs["gripper_position"], dtype=np.float32)[:, -1:]
    return traj


def ppgm(traj: Traj) -> Traj:
    """transforms.py:95-110 (ppgm_dataset_transform, registered for
    ppgm/ppgm_static/ppgm_wrist at :1013-1015 — the registry's long tail;
    not in any released mixture): binarize gripper onto action[:6];
    EEF_state from cartesian_position[:, :6], gripper_state from
    gripper_position[:, -1:]."""
    a = np.asarray(traj["action"], dtype=np.float32)
    traj["action"] = _cat(a[:, :6], binarize_gripper_actions(a[:, -1])[:, None])
    obs = traj["observation"]
    obs["EEF_state"] = np.asarray(obs["cartesian_position"], dtype=np.float32)[:, :6]
    obs["gripper_state"] = np.asarray(obs["gripper_position"], dtype=np.float32)[:, -1:]
    return traj


def droid_finetuning(traj: Traj) -> Traj:
    act = traj["action_dict"]
    vel = np.asarray(act["cartesian_velocity"], dtype=np.float32)
    grip = 1 - np.asarray(act["gripper_position"], dtype=np.float32)
    traj["action"] = _cat(vel[:, :3], vel[:, 3:6], grip)
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["cartesian_position"], obs["gripper_position"])
    return traj


STANDARDIZE_FNS: Dict[str, Callable[[Traj], Traj]] = {
    "fractal20220817_data/0.1.0": rt1,
    "kuka/0.1.0": kuka,
    "bridge_orig/1.0.0": bridge_orig,
    "bridge_dataset/0.1.0": bridge_orig,
    "taco_play/0.1.0": taco_play,
    "jaco_play/0.1.0": jaco_play,
    "berkeley_cable_routing/0.1.0": berkeley_cable_routing,
    "roboturk/0.1.0": roboturk,
    "viola/0.1.0": viola,
    "berkeley_autolab_ur5/0.1.0": berkeley_autolab_ur5,
    "toto/0.1.0": toto,
    "language_table/0.1.0": language_table,
    "stanford_hydra_dataset_converted_externally_to_rlds/0.1.0": stanford_hydra,
    "austin_buds_dataset_converted_externally_to_rlds/0.1.0": austin_buds,
    "nyu_franka_play_dataset_converted_externally_to_rlds/0.1.0": nyu_franka_play,
    "furniture_bench_dataset_converted_externally_to_rlds/0.1.0": furniture_bench,
    "ucsd_kitchen_dataset_converted_externally_to_rlds/0.1.0": ucsd_kitchen,
    "austin_sailor_dataset_converted_externally_to_rlds/0.1.0": austin_sailor_sirius,
    "austin_sirius_dataset_converted_externally_to_rlds/0.1.0": austin_sailor_sirius,
    "dlr_edan_shared_control_converted_externally_to_rlds/0.1.0": dlr_edan,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds/0.1.0": iamlab_cmu,
    "utaustin_mutex/0.1.0": utaustin_mutex,
    "berkeley_fanuc_manipulation/0.1.0": berkeley_fanuc,
    "cmu_stretch/0.1.0": cmu_stretch,
    "bc_z/0.1.0": bc_z,
    "fmb_dataset/1.0.0": fmb,
    "dobbe/0.0.1": dobbe,
    "droid/1.0.0": droid_baseact,
    "rh20t_rlds/1.0.0": rh20t,
    "uiuc_d3field/0.1.0": uiuc_d3field,
    "libero_spatial_no_noops/1.0.0": libero,
    "libero_object_no_noops/1.0.0": libero,
    "libero_goal_no_noops/1.0.0": libero,
    "libero_10_no_noops/1.0.0": libero,
    "simpler_env/0.1.0": identity,
    # long-tail OXE coverage
    "bridge_oxe/0.1.0": bridge_oxe,
    "roboturk_tiny/0.1.0": roboturk,
    "nyu_door_opening_surprising_effectiveness/0.1.0": nyu_door_opening,
    "columbia_cairlab_pusht_real/0.1.0": pusht,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds/0.1.0": stanford_kuka_multimodal,
    "nyu_rot_dataset_converted_externally_to_rlds/0.1.0": nyu_rot,
    "maniskill_dataset_converted_externally_to_rlds/0.1.0": maniskill,
    "cmu_franka_exploration_dataset_converted_externally_to_rlds/0.1.0": cmu_franka_exploration,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds/0.1.0": ucsd_pick_place,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds/0.1.0": tokyo_pr2,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds/0.1.0": tokyo_pr2,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds/0.1.0": utokyo_xarm_pick_place,
    "utokyo_xarm_bimanual_converted_externally_to_rlds/0.1.0": utokyo_xarm_bimanual,
    "robo_net/0.1.0": robo_net,
    "berkeley_mvp_converted_externally_to_rlds/0.1.0": identity,
    "berkeley_rpt_converted_externally_to_rlds/0.1.0": identity,
    "kaist_nonprehensile_converted_externally_to_rlds/0.1.0": kaist_nonprehensile,
    "stanford_mask_vit_converted_externally_to_rlds/0.1.0": stanford_mask_vit,
    "tokyo_u_lsmo_converted_externally_to_rlds/0.1.0": eef_gripper_state_split,
    "dlr_sara_pour_converted_externally_to_rlds/0.1.0": dlr_sara_pour,
    "dlr_sara_grid_clamp_converted_externally_to_rlds/0.1.0": dlr_sara_grid_clamp,
    "asu_table_top_converted_externally_to_rlds/0.1.0": asu_table_top,
    "stanford_robocook_converted_externally_to_rlds/0.1.0": robocook,
    "imperialcollege_sawyer_wrist_cam/0.1.0": imperial_wristcam,
    "cmu_playing_with_food/0.1.0": cmu_playing_with_food,
    "cmu_play_fusion/0.1.0": playfusion,
    "berkeley_gnm_recon/0.1.0": gnm,
    "berkeley_gnm_cory_hall/0.1.0": gnm,
    "berkeley_gnm_sac_son/0.1.0": gnm,
    "roboset/0.1.0": identity,
    "tdroid_carrot_in_bowl/0.1.0": tdroid,
    "tdroid_pour_corn_in_pot/0.1.0": tdroid,
    "tdroid_flip_pot_upright/0.1.0": tdroid,
    "tdroid_move_object_onto_plate/0.1.0": tdroid,
    "tdroid_knock_object_over/0.1.0": tdroid,
    "tdroid_cover_object_with_towel/0.1.0": tdroid,
    "droid_wipe/0.1.0": droid_finetuning,
    "ppgm/0.1.0": ppgm,
    "ppgm_static/0.1.0": ppgm,
    "ppgm_wrist/0.1.0": ppgm,
}


# DROID zero-action chunk filter (droid_utils.py:156-188): drop frames whose
# normalized action (vs hardcoded DROID q01/q99) is all-near-zero.
DROID_Q01 = np.array(
    [-0.7776297926902771, -0.5803514122962952, -0.5795090794563293,
     -0.6464047729969025, -0.7041108310222626, -0.8895104378461838], np.float32)
DROID_Q99 = np.array(
    [0.7597932070493698, 0.5726242214441299, 0.7351000607013702,
     0.6705610305070877, 0.6464948207139969, 0.8897542208433151], np.float32)


def droid_zero_action_filter(frame_action: np.ndarray) -> bool:
    """True = keep the frame. frame_action: (..., 7) chunked actions (first
    step decides)."""
    a = np.asarray(frame_action)
    first = a[0] if a.ndim == 2 else a
    norm = 2 * (first[:6] - DROID_Q01) / (DROID_Q99 - DROID_Q01) - 1
    return bool(np.linalg.norm(norm) > 1e-5)


CHUNK_FILTERS: Dict[str, Callable] = {
    "droid_zero_action": droid_zero_action_filter,
}
