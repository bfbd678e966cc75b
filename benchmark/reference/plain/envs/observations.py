"""Observation dict + config-selected policy tensor (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/observations.py`: the
default observation set (finite-difference DOF velocities, contact
binary/duration tracking, hand and fingertip/fingerpad poses in world and
hand frame) and the concatenation of `policy_observation_keys`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.plain.constants import ACTIVE_FINGER_DOF_INDICES, NUM_BASE_DOFS
from benchmark.reference.plain.models.dexhand021 import HandModel
from benchmark.reference.plain.ops import quat as qm
from benchmark.reference.plain.physics.types import KinematicsOut

_SQRT_HALF = 0.7071067811865476
# the model's built-in rotation: hand quat is Ry(90 deg) at ARR=0
BUILTIN_ROT = np.array([0.0, _SQRT_HALF, 0.0, _SQRT_HALF], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    policy_observation_keys: Tuple[str, ...]
    contact_body_indices: np.ndarray   # (n,) hand body indices monitored
    contact_binary_threshold: float
    control_dt: float
    num_contact_bodies: int
    hand_body_index: int
    fingertip_site_indices: np.ndarray  # (5,)
    fingerpad_site_indices: np.ndarray  # (5,)
    num_actions: int
    critic_observation_keys: Tuple[str, ...] = ()


def build_obs_config(model: HandModel, policy_observation_keys, contact_force_bodies,
                     contact_binary_threshold, control_dt, num_actions,
                     critic_observation_keys=()) -> ObsConfig:
    return ObsConfig(
        policy_observation_keys=tuple(policy_observation_keys),
        contact_body_indices=np.asarray([model.body_index(b) for b in contact_force_bodies]),
        num_contact_bodies=len(list(contact_force_bodies)),
        contact_binary_threshold=float(contact_binary_threshold),
        control_dt=float(control_dt),
        hand_body_index=model.body_index("right_hand_base"),
        fingertip_site_indices=np.asarray(
            [model.site_index("r_f_link%d_tip" % f) for f in range(1, 6)]),
        fingerpad_site_indices=np.asarray(
            [model.site_index("r_f_link%d_pad" % f) for f in range(1, 6)]),
        num_actions=num_actions,
        critic_observation_keys=tuple(critic_observation_keys),
    )


def default_obs_dims(cfg: ObsConfig) -> Dict[str, int]:
    """Width of every default observation key (the obs row plan)."""
    nc = cfg.num_contact_bodies
    return {
        "base_dof_pos": 6, "base_dof_vel": 6, "active_finger_dof_pos": 12,
        "active_finger_dof_vel": 12, "all_finger_dof_pos": 20, "all_finger_dof_vel": 20,
        "hand_pose": 7, "hand_pose_arr_aligned": 7, "contact_forces": 3 * nc,
        "contact_force_magnitude": nc, "contact_binary": nc, "contact_duration": nc,
        "prev_actions": cfg.num_actions, "active_prev_targets": 18, "base_dof_target": 6,
        "active_finger_dof_target": 12, "all_finger_dof_target": 20,
        "fingertip_poses_world": 35, "fingertip_poses_hand": 35,
        "fingerpad_poses_world": 35, "fingerpad_poses_hand": 35, "episode_time": 1,
    }


def poses_to_hand_frame(poses_world, hand_pose):
    """(N, 35) world-frame finger poses -> hand frame."""
    n = poses_world.shape[0]
    p = poses_world.reshape(n, 5, 7)
    hand_pos, hand_quat = hand_pose[:, None, :3], hand_pose[:, None, 3:7]
    pos_h = qm.point_in_hand_frame(p[..., :3], hand_pos, hand_quat)
    quat_h = qm.quat_mul(qm.quat_conjugate(hand_quat), p[..., 3:7])
    return torch.cat([pos_h, quat_h], dim=-1).reshape(n, 35)


def compute_default_observations(
    cfg: ObsConfig, kin: KinematicsOut, dof_pos, prev_dof_pos, full_dof_targets,
    active_prev_targets, prev_actions, body_contact_force,
    contact_duration_steps, prev_contact_binary, episode_step_count,
):
    """Returns (obs_dict, new_contact_duration_steps, contact_binary)."""
    obs: Dict[str, torch.Tensor] = {}
    dof_vel = (dof_pos - prev_dof_pos) / cfg.control_dt
    act_idx = list(ACTIVE_FINGER_DOF_INDICES)
    obs["base_dof_pos"] = dof_pos[:, :NUM_BASE_DOFS]
    obs["base_dof_vel"] = dof_vel[:, :NUM_BASE_DOFS]
    obs["active_finger_dof_pos"] = dof_pos[:, act_idx]
    obs["active_finger_dof_vel"] = dof_vel[:, act_idx]
    obs["all_finger_dof_pos"] = dof_pos[:, NUM_BASE_DOFS:]
    obs["all_finger_dof_vel"] = dof_vel[:, NUM_BASE_DOFS:]

    hb = cfg.hand_body_index
    hand_pose = torch.cat([kin.body_pos[:, hb], kin.body_quat[:, hb]], dim=-1)
    obs["hand_pose"] = hand_pose
    inv = qm.quat_conjugate(torch.as_tensor(BUILTIN_ROT, device=dof_pos.device))
    obs["hand_pose_arr_aligned"] = torch.cat(
        [hand_pose[:, :3], qm.quat_mul(hand_pose[:, 3:7], inv)], dim=-1)

    n = dof_pos.shape[0]
    cf = body_contact_force[:, list(cfg.contact_body_indices)]
    obs["contact_forces"] = cf.reshape(n, -1)
    mags = torch.linalg.vector_norm(cf, dim=-1)
    obs["contact_force_magnitude"] = mags
    binary = (mags > cfg.contact_binary_threshold).float()
    obs["contact_binary"] = binary
    started = (binary == 1.0) & (prev_contact_binary == 0.0)
    active = binary == 1.0
    new_duration = torch.where(
        started, torch.ones_like(contact_duration_steps),
        torch.where(active, contact_duration_steps + 1, torch.zeros_like(contact_duration_steps)),
    )
    obs["contact_duration"] = new_duration.float() * cfg.control_dt

    obs["prev_actions"] = prev_actions
    obs["active_prev_targets"] = active_prev_targets
    obs["base_dof_target"] = full_dof_targets[:, :NUM_BASE_DOFS]
    obs["active_finger_dof_target"] = full_dof_targets[:, act_idx]
    obs["all_finger_dof_target"] = full_dof_targets[:, NUM_BASE_DOFS:]

    def site_poses(idx):
        idx = list(idx)
        return torch.cat([kin.site_pos[:, idx], kin.site_quat[:, idx]], dim=-1).reshape(n, 35)

    tip_world = site_poses(cfg.fingertip_site_indices)
    pad_world = site_poses(cfg.fingerpad_site_indices)
    obs["fingertip_poses_world"] = tip_world
    obs["fingertip_poses_hand"] = poses_to_hand_frame(tip_world, hand_pose)
    obs["fingerpad_poses_world"] = pad_world
    obs["fingerpad_poses_hand"] = poses_to_hand_frame(pad_world, hand_pose)
    obs["episode_time"] = (episode_step_count.float() * cfg.control_dt)[:, None]
    return obs, new_duration, binary


def concat_selected_observations(cfg: ObsConfig, obs_dict, keys=None) -> torch.Tensor:
    parts = []
    for key in cfg.policy_observation_keys if keys is None else keys:
        if key not in obs_dict:
            raise KeyError(f"observation key '{key}' not in obs_dict "
                           f"(available: {sorted(obs_dict)})")
        v = obs_dict[key]
        parts.append(v if v.ndim == 2 else v.reshape(v.shape[0], -1))
    return torch.cat(parts, dim=-1)
