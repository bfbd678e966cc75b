"""Common reward terms + weighted aggregation (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/rewards.py`: the ten
builtin shaping terms and the weighted sum where a weight of 0 skips a term.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from benchmark.reference.plain.constants import NUM_BASE_DOFS

COMMON_TERMS = (
    "alive", "height_safety", "finger_velocity", "hand_velocity",
    "hand_angular_velocity", "joint_limit", "finger_acceleration",
    "hand_acceleration", "hand_angular_acceleration", "contact_stability",
)


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    weights: Dict[str, float]
    finger_lower_limits: np.ndarray  # (20,)
    finger_upper_limits: np.ndarray  # (20,)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=1)


def compute_common_reward_terms(cfg: RewardConfig, obs_dict, dof_pos, dof_vel,
                                hand_vel, hand_ang_vel, prev_finger_dof_vel,
                                prev_hand_vel, prev_hand_ang_vel, prev_contacts):
    """Returns (rewards, tracking state for the next step)."""
    n = dof_pos.shape[0]
    finger_vel = dof_vel[:, NUM_BASE_DOFS:]
    finger_pos = dof_pos[:, NUM_BASE_DOFS:]
    r: Dict[str, torch.Tensor] = {}
    r["alive"] = torch.ones(n, dtype=dof_pos.dtype, device=dof_pos.device)
    min_tip = obs_dict["fingertip_poses_world"].reshape(n, 5, 7)[:, :, 2].amin(dim=1)
    r["height_safety"] = torch.clamp(1.0 - torch.exp(-(min_tip - 0.02) * 20.0), 0.0, 1.0)
    r["finger_velocity"] = torch.exp(-0.1 * _norm(finger_vel))
    r["hand_velocity"] = torch.exp(-0.2 * _norm(hand_vel))
    r["hand_angular_velocity"] = torch.exp(-0.2 * _norm(hand_ang_vel))
    lo = torch.as_tensor(cfg.finger_lower_limits, device=dof_pos.device)
    rng = torch.as_tensor(cfg.finger_upper_limits, device=dof_pos.device) - lo
    normalized = torch.where(
        rng > 0, 2.0 * (finger_pos - lo) / torch.where(rng > 0, rng, torch.ones_like(rng)) - 1.0,
        torch.zeros_like(finger_pos))
    over = torch.clamp(normalized.abs() - 0.8, 0.0, 1.0)
    r["joint_limit"] = 1.0 - over.sum(dim=1) / finger_pos.shape[1]
    r["finger_acceleration"] = torch.exp(-2.0 * _norm(finger_vel - prev_finger_dof_vel))
    r["hand_acceleration"] = torch.exp(-0.5 * _norm(hand_vel - prev_hand_vel))
    r["hand_angular_acceleration"] = torch.exp(-0.5 * _norm(hand_ang_vel - prev_hand_ang_vel))
    cf = obs_dict["contact_forces"]
    contacts = torch.linalg.vector_norm(cf.reshape(n, cf.shape[1] // 3, 3), dim=2) > 0.1
    changes = torch.logical_xor(contacts, prev_contacts).sum(dim=1).to(dof_pos.dtype)
    r["contact_stability"] = torch.exp(-changes)
    tracking = {
        "prev_finger_dof_vel": finger_vel,
        "prev_hand_vel": hand_vel,
        "prev_hand_ang_vel": hand_ang_vel,
        "prev_contacts": contacts,
    }
    return r, tracking


def compute_total_reward(cfg: RewardConfig, common, task):
    """Weighted sum over sorted term names; logs raw + `_weighted`."""
    all_r = {**common, **task}
    total = torch.zeros_like(next(iter(all_r.values())))
    comps: Dict[str, torch.Tensor] = {}
    for name in sorted(all_r):
        w = cfg.weights.get(name, 0.0)
        if w != 0.0:
            weighted = all_r[name] * w
            total = total + weighted
            comps[name] = all_r[name]
            comps[f"{name}_weighted"] = weighted
    comps["total"] = total
    return total, comps
