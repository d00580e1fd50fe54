"""Open-X Embodiment dataset registry: per-dataset observation/state/action
schemas, standardization transforms, and named training mixtures.

Re-expression of the reference registry (data/oxe/configs.py — 71 entries,
data/oxe/mixtures.py, data/oxe/transforms.py registry dict) as typed
dataclasses. This round covers every dataset used by the released
SpatialVLA mixtures (oxe_spatial_vla_plus & stage2, rtx, bridge, fractal,
uiuc_d3field) plus eval passthroughs; remaining long-tail OXE entries are
additive.
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Callable, Dict, List, Optional, Tuple


class StateEncoding(IntEnum):
    NONE = -1
    POS_EULER = 1   # EEF XYZ + RPY + pad + gripper
    POS_QUAT = 2    # EEF XYZ + quat + gripper
    JOINT = 3       # joint angles + gripper
    JOINT_BIMANUAL = 4


class ActionEncoding(IntEnum):
    EEF_POS = 1     # dXYZ + dRPY + gripper (7)
    JOINT_POS = 2
    JOINT_POS_BIMANUAL = 3
    EEF_R6 = 4      # dXYZ + R6 + gripper (10)


@dataclasses.dataclass(frozen=True)
class OXEDatasetConfig:
    image_obs_keys: Dict[str, Optional[str]]
    depth_obs_keys: Dict[str, Optional[str]]
    state_obs_keys: Tuple[Optional[str], ...]
    state_encoding: StateEncoding
    action_encoding: ActionEncoding
    language_key: Optional[str] = "language_instruction"
    chunk_filter: Optional[str] = None  # name of a registered chunk filter


def _cfg(primary=None, secondary=None, wrist=None, d_primary=None,
         d_secondary=None, d_wrist=None, state=(), se=StateEncoding.NONE,
         ae=ActionEncoding.EEF_POS, **kw) -> OXEDatasetConfig:
    return OXEDatasetConfig(
        image_obs_keys={"primary": primary, "secondary": secondary, "wrist": wrist},
        depth_obs_keys={"primary": d_primary, "secondary": d_secondary, "wrist": d_wrist},
        state_obs_keys=tuple(state),
        state_encoding=se,
        action_encoding=ae,
        **kw,
    )


PE, PQ, JT, NONE = (StateEncoding.POS_EULER, StateEncoding.POS_QUAT,
                    StateEncoding.JOINT, StateEncoding.NONE)

DATASET_CONFIGS: Dict[str, OXEDatasetConfig] = {
    "fractal20220817_data/0.1.0": _cfg(
        primary="image", state=["base_pose_tool_reached", "gripper_closed"], se=PQ),
    "kuka/0.1.0": _cfg(
        primary="image",
        state=["clip_function_input/base_pose_tool_reached", "gripper_closed"], se=PQ),
    "bridge_orig/1.0.0": _cfg(
        primary="image_0", secondary="image_1",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "bridge_dataset/0.1.0": _cfg(
        primary="image_0", secondary="image_1",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "taco_play/0.1.0": _cfg(
        primary="rgb_static", wrist="rgb_gripper",
        d_primary="depth_static", d_wrist="depth_gripper",
        state=["state_eef", None, "state_gripper"], se=PE),
    "jaco_play/0.1.0": _cfg(
        primary="image", wrist="image_wrist",
        state=["state_eef", None, "state_gripper"], se=PE),
    "berkeley_cable_routing/0.1.0": _cfg(
        primary="image", secondary="top_image", wrist="wrist45_image",
        state=["robot_state", None], se=JT),
    "roboturk/0.1.0": _cfg(
        primary="front_rgb", state=[None] * 8, se=NONE),
    "viola/0.1.0": _cfg(
        primary="agentview_rgb", wrist="eye_in_hand_rgb",
        state=["joint_states", "gripper_states"], se=JT),
    "berkeley_autolab_ur5/0.1.0": _cfg(
        primary="image", wrist="hand_image", d_primary="depth",
        state=["state"], se=PQ),
    "toto/0.1.0": _cfg(primary="image", state=["state", None], se=JT),
    "language_table/0.1.0": _cfg(
        primary="rgb", state=["effector_translation"] + [None] * 6, se=PE),
    "stanford_hydra_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", wrist="wrist_image",
        state=["eef_state", None, "gripper_state"], se=PE),
    "austin_buds_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", wrist="wrist_image", state=["state"], se=JT),
    "nyu_franka_play_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", secondary="image_additional_view",
        d_primary="depth", d_secondary="depth_additional_view",
        state=["eef_state", None, None], se=PE),
    "furniture_bench_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", wrist="wrist_image", state=["state"], se=PQ),
    "ucsd_kitchen_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["joint_state", None], se=JT),
    "austin_sailor_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", wrist="wrist_image", state=["state"], se=PQ),
    "austin_sirius_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", wrist="wrist_image", state=["state"], se=PQ),
    "dlr_edan_shared_control_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["state", None], se=PE),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", wrist="wrist_image",
        state=["joint_state", "gripper_state"], se=JT),
    "utaustin_mutex/0.1.0": _cfg(
        primary="image", wrist="wrist_image", state=["state"], se=JT),
    "berkeley_fanuc_manipulation/0.1.0": _cfg(
        primary="image", wrist="wrist_image",
        state=["joint_state", None, "gripper_state"], se=JT),
    "cmu_stretch/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "bc_z/0.1.0": _cfg(
        primary="image",
        state=["present/xyz", "present/axis_angle", None, "present/sensed_close"],
        se=PE),
    "fmb_dataset/1.0.0": _cfg(
        primary="image_side_1", secondary="image_side_2", wrist="image_wrist_1",
        d_primary="image_side_1_depth", d_secondary="image_side_2_depth",
        d_wrist="image_wrist_1_depth", state=["proprio"], se=PE),
    "dobbe/0.0.1": _cfg(primary="wrist_image", state=["proprio"], se=PE),
    "droid/1.0.0": _cfg(
        primary="exterior_image_1_left", secondary="exterior_image_2_left",
        wrist="wrist_image_left", state=["proprio"], se=PQ,
        chunk_filter="droid_zero_action"),
    "rh20t_rlds/1.0.0": _cfg(primary="image", state=["proprio"], se=PE),
    "uiuc_d3field/0.1.0": _cfg(
        primary="image_1", secondary="image_2", d_primary="depth_1",
        d_secondary="depth_2", state=[None] * 8, se=NONE),
    "libero_spatial_no_noops/1.0.0": _cfg(
        primary="image", wrist="wrist_image", state=["EEF_state", None, "gripper_state"], se=PE),
    "libero_object_no_noops/1.0.0": _cfg(
        primary="image", wrist="wrist_image", state=["EEF_state", None, "gripper_state"], se=PE),
    "libero_goal_no_noops/1.0.0": _cfg(
        primary="image", wrist="wrist_image", state=["EEF_state", None, "gripper_state"], se=PE),
    "libero_10_no_noops/1.0.0": _cfg(
        primary="image", wrist="wrist_image", state=["EEF_state", None, "gripper_state"], se=PE),
    "simpler_env/0.1.0": _cfg(
        primary="image", state=[None] * 8, se=NONE),
    # long-tail OXE coverage (reference configs.py entries beyond the
    # SpatialVLA mixtures)
    "bridge_oxe/0.1.0": _cfg(
        primary="image", secondary="image_1",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "roboturk_tiny/0.1.0": _cfg(primary="front_rgb", state=[None] * 8, se=NONE),
    "nyu_door_opening_surprising_effectiveness/0.1.0": _cfg(
        wrist="image", state=[None] * 8, se=NONE),
    "columbia_cairlab_pusht_real/0.1.0": _cfg(
        primary="image", wrist="wrist_image",
        state=["robot_state"] + [None] * 6, se=PE),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", d_primary="depth_image",
        state=["ee_position", "ee_orientation", None], se=PQ),
    "nyu_rot_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "maniskill_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", wrist="wrist_image", d_primary="depth",
        d_wrist="wrist_depth", state=["tcp_pose", "gripper_state"], se=PQ),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="highres_image", state=[None] * 8, se=NONE),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", secondary="image2", wrist="hand_image",
        state=["end_effector_pose", None, None], se=PE),
    "utokyo_xarm_bimanual_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["pose_r", None, None], se=PE),
    "robo_net/0.1.0": _cfg(
        primary="image", secondary="image1",
        state=["eef_state", None, "gripper_state"], se=PE),
    "berkeley_mvp_converted_externally_to_rlds/0.1.0": _cfg(
        wrist="hand_image", state=["pose", "gripper"], se=PQ,
        ae=ActionEncoding.JOINT_POS),
    "berkeley_rpt_converted_externally_to_rlds/0.1.0": _cfg(
        wrist="hand_image", state=["joint_pos", "gripper"], se=JT,
        ae=ActionEncoding.JOINT_POS),
    "kaist_nonprehensile_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["state", None], se=PQ),
    "stanford_mask_vit_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "tokyo_u_lsmo_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "dlr_sara_pour_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["state", None, None], se=PE),
    "dlr_sara_grid_clamp_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["state", None, None], se=PE),
    "asu_table_top_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image", state=["eef_state", None, "gripper_state"], se=PE),
    "stanford_robocook_converted_externally_to_rlds/0.1.0": _cfg(
        primary="image_1", secondary="image_2", d_primary="depth_1",
        d_secondary="depth_2", state=["eef_state", None, "gripper_state"], se=PE),
    "imperialcollege_sawyer_wrist_cam/0.1.0": _cfg(
        primary="image", wrist="wrist_image",
        state=[None] * 7 + ["state"], se=NONE),
    "cmu_playing_with_food/0.1.0": _cfg(
        primary="image", wrist="finger_vision_1",
        state=["state", None, None], se=PE),
    "cmu_play_fusion/0.1.0": _cfg(primary="image", state=["state"], se=JT),
    "berkeley_gnm_recon/0.1.0": _cfg(
        wrist="image", state=["state", None, None], se=PE),
    "berkeley_gnm_cory_hall/0.1.0": _cfg(
        wrist="image", state=["state", None, None], se=PE),
    "berkeley_gnm_sac_son/0.1.0": _cfg(
        wrist="image", state=["state", None, None], se=PE),
    "roboset/0.1.0": _cfg(
        primary="image_left", secondary="image_right", wrist="image_wrist",
        state=["proprio"], se=JT, ae=ActionEncoding.JOINT_POS),
    "tdroid_carrot_in_bowl/0.1.0": _cfg(
        primary="static_image", d_primary="static_depth_image",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "tdroid_pour_corn_in_pot/0.1.0": _cfg(
        primary="static_image", d_primary="static_depth_image",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "tdroid_flip_pot_upright/0.1.0": _cfg(
        primary="static_image", d_primary="static_depth_image",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "tdroid_move_object_onto_plate/0.1.0": _cfg(
        primary="static_image", d_primary="static_depth_image",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "tdroid_knock_object_over/0.1.0": _cfg(
        primary="static_image", d_primary="static_depth_image",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "tdroid_cover_object_with_towel/0.1.0": _cfg(
        primary="static_image", d_primary="static_depth_image",
        state=["EEF_state", None, "gripper_state"], se=PE),
    "droid_wipe/0.1.0": _cfg(
        primary="exterior_image_2_left", wrist="wrist_image_left",
        state=["proprio"], se=PE),
}


# -- named mixtures (data/oxe/mixtures.py) ----------------------------------

_SPATIAL_VLA_PLUS_CORE: List[Tuple[str, float]] = [
    ("fractal20220817_data/0.1.0", 0.54087122203),
    ("kuka/0.1.0", 0.4),
    ("bridge_orig/1.0.0", 1.0),
    ("taco_play/0.1.0", 2.0),
    ("jaco_play/0.1.0", 1.0),
    ("berkeley_cable_routing/0.1.0", 1.0),
    ("roboturk/0.1.0", 2.0),
    ("viola/0.1.0", 2.0),
    ("berkeley_autolab_ur5/0.1.0", 2.0),
    ("toto/0.1.0", 0.5),
    ("language_table/0.1.0", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds/0.1.0", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds/0.1.0", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds/0.1.0", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds/0.1.0", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds/0.1.0", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds/0.1.0", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds/0.1.0", 1.0),
    ("dlr_edan_shared_control_converted_externally_to_rlds/0.1.0", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds/0.1.0", 1.0),
    ("utaustin_mutex/0.1.0", 1.0),
    ("berkeley_fanuc_manipulation/0.1.0", 0.5),
    ("cmu_stretch/0.1.0", 1.0),
    ("bc_z/0.1.0", 0.2),
    ("fmb_dataset/1.0.0", 0.2),
    ("dobbe/0.0.1", 0.2),
    ("rh20t_rlds/1.0.0", 0.015),
]

NAMED_MIXTURES: Dict[str, List[Tuple[str, float]]] = {
    "uiuc_d3field": [("uiuc_d3field/0.1.0", 1.0)],
    "bridge": [("bridge_orig/1.0.0", 1.0)],
    "fractal": [("fractal20220817_data/0.1.0", 1.0)],
    "droid": [("droid/1.0.0", 1.0)],
    "bridge_rt_1": [("bridge_orig/1.0.0", 1.0), ("fractal20220817_data/0.1.0", 1.0)],
    "rtx": [
        ("fractal20220817_data/0.1.0", 0.54087122203),
        ("kuka/0.1.0", 0.8341046294),
        ("bridge_orig/1.0.0", 1.0),
        ("taco_play/0.1.0", 2.0),
        ("jaco_play/0.1.0", 2.0),
        ("berkeley_cable_routing/0.1.0", 3.0),
        ("roboturk/0.1.0", 1.0),
        ("viola/0.1.0", 2.0),
        ("berkeley_autolab_ur5/0.1.0", 1.0),
        ("toto/0.1.0", 1.0),
    ],
    "kuka": [("kuka/0.1.0", 1.0)],
    "droid_wipe": [("droid_wipe/0.1.0", 1.0)],
    "rtx_franka": [
        ("fractal20220817_data/0.1.0", 0.54087122203),
        ("kuka/0.1.0", 0.8341046294),
        ("bridge_orig/1.0.0", 1.0),
        ("taco_play/0.1.0", 2.0),
        ("jaco_play/0.1.0", 2.0),
        ("berkeley_cable_routing/0.1.0", 3.0),
        ("roboturk/0.1.0", 1.0),
        ("viola/0.1.0", 2.0),
        ("berkeley_autolab_ur5/0.1.0", 1.0),
        ("toto/0.1.0", 1.0),
        ("taco_play/0.1.0", 1.0),
        ("berkeley_cable_routing/0.1.0", 1.0),
        ("viola/0.1.0", 1.0),
        ("toto/0.1.0", 1.0),
        ("stanford_hydra_dataset_converted_externally_to_rlds/0.1.0", 1.0),
        ("austin_buds_dataset_converted_externally_to_rlds/0.1.0", 3.0),
        ("nyu_franka_play_dataset_converted_externally_to_rlds/0.1.0", 3.0),
        ("maniskill_dataset_converted_externally_to_rlds/0.1.0", 0.1),
        ("furniture_bench_dataset_converted_externally_to_rlds/0.1.0", 0.1),
        ("cmu_franka_exploration_dataset_converted_externally_to_rlds/0.1.0", 5.0),
        ("austin_sailor_dataset_converted_externally_to_rlds/0.1.0", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds/0.1.0", 1.0),
        ("berkeley_rpt_converted_externally_to_rlds/0.1.0", 1.0),
        ("kaist_nonprehensile_converted_externally_to_rlds/0.1.0", 3.0),
        ("stanford_robocook_converted_externally_to_rlds/0.1.0", 1.0),
        ("iamlab_cmu_pickup_insert_converted_externally_to_rlds/0.1.0", 1.0),
        ("utaustin_mutex/0.1.0", 1.0),
        ("cmu_play_fusion/0.1.0", 1.0),
    ],
    "oxe_magic_soup_plus": [
        ("fractal20220817_data/0.1.0", 0.54087122203),
        ("kuka/0.1.0", 0.8341046294),
        ("bridge_orig/1.0.0", 1.0),
        ("taco_play/0.1.0", 2.0),
        ("jaco_play/0.1.0", 1.0),
        ("berkeley_cable_routing/0.1.0", 1.0),
        ("roboturk/0.1.0", 2.0),
        ("viola/0.1.0", 2.0),
        ("berkeley_autolab_ur5/0.1.0", 2.0),
        ("toto/0.1.0", 1.0),
        ("language_table/0.1.0", 0.1),
        ("stanford_hydra_dataset_converted_externally_to_rlds/0.1.0", 2.0),
        ("austin_buds_dataset_converted_externally_to_rlds/0.1.0", 1.0),
        ("nyu_franka_play_dataset_converted_externally_to_rlds/0.1.0", 3.0),
        ("furniture_bench_dataset_converted_externally_to_rlds/0.1.0", 0.1),
        ("ucsd_kitchen_dataset_converted_externally_to_rlds/0.1.0", 2.0),
        ("austin_sailor_dataset_converted_externally_to_rlds/0.1.0", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds/0.1.0", 1.0),
        ("dlr_edan_shared_control_converted_externally_to_rlds/0.1.0", 1.0),
        ("iamlab_cmu_pickup_insert_converted_externally_to_rlds/0.1.0", 1.0),
        ("utaustin_mutex/0.1.0", 1.0),
        ("berkeley_fanuc_manipulation/0.1.0", 2.0),
        ("cmu_stretch/0.1.0", 1.0),
        ("bc_z/0.1.0", 0.2),
        ("fmb_dataset/1.0.0", 1.0),
        ("dobbe/0.0.1", 0.2),
        ("droid/1.0.0", 0.06),
    ],
    "oxe_spatial_vla_plus": _SPATIAL_VLA_PLUS_CORE + [("droid/1.0.0", 0.06)],
    "oxe_spatial_vla_plus_stage2": list(_SPATIAL_VLA_PLUS_CORE),
    "libero": [
        ("libero_spatial_no_noops/1.0.0", 1.0),
        ("libero_object_no_noops/1.0.0", 1.0),
        ("libero_goal_no_noops/1.0.0", 1.0),
        ("libero_10_no_noops/1.0.0", 1.0),
    ],
}

# datasets excluded when fitting the tokenizer Gaussians
EXCLUDE_MIXTURES: Dict[str, List[str]] = {
    "tokenizer_gaussian": [
        "language_table/0.1.0",
        "berkeley_fanuc_manipulation/0.1.0",
        "cmu_stretch/0.1.0",
        "jaco_play/0.1.0",
    ],
    "no_exclude": [],
}


def get_config(name: str) -> OXEDatasetConfig:
    if name not in DATASET_CONFIGS:
        raise KeyError(
            f"dataset '{name}' not in registry; known: {sorted(DATASET_CONFIGS)}"
        )
    return DATASET_CONFIGS[name]


def resolve_mixture(name_or_list) -> List[Tuple[str, float]]:
    if isinstance(name_or_list, str):
        if name_or_list in NAMED_MIXTURES:
            return list(NAMED_MIXTURES[name_or_list])
        return [(name_or_list, 1.0)]  # single dataset name
    return list(name_or_list)
