"""Action pipeline: rule -> post-action filters -> 18 -> 26 coupling (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/action.py` for the
builtin rules (position, position_delta) and filters (velocity_clamp,
position_clamp). Static limits, max deltas and the coupling map are built
once from the model and config.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.constants import (
    ACTIVE_FINGER_DOF_INDICES,
    DOF_INDEX,
    FINGER_COUPLING_MAP,
    NUM_BASE_DOFS,
    NUM_DOFS,
)
from dexrobot_isaac_tpu_torch.models.dexhand021 import HandModel

ACTIVE_IDX = list(range(NUM_BASE_DOFS)) + list(ACTIVE_FINGER_DOF_INDICES)


@dataclasses.dataclass(frozen=True)
class ActionPipeline:
    control_mode: str                 # "position" | "position_delta"
    policy_controls_base: bool
    policy_controls_fingers: bool
    num_actions: int
    active_lower: np.ndarray          # (18,) float32
    active_upper: np.ndarray          # (18,)
    max_deltas: np.ndarray            # (18,) control_dt * per-component vel limit
    coupling_src: np.ndarray          # (26,) int: full DOF d <- active[src[d]]
    coupling_scale: np.ndarray        # (26,) float32 (0 = pinned at 0)
    post_action_filters: Tuple[str, ...] = ("velocity_clamp", "position_clamp")


def build_action_pipeline(
    model: HandModel,
    control_mode: str,
    control_dt: float,
    policy_controls_base: bool = True,
    policy_controls_fingers: bool = True,
    max_base_linear_velocity: float = 0.5,
    max_base_angular_velocity: float = 1.5,
    max_finger_joint_velocity: float = 1.0,
) -> ActionPipeline:
    if control_mode not in ("position", "position_delta"):
        raise ValueError(f"Unknown control mode: {control_mode}")
    max_deltas = control_dt * np.array(
        [max_base_linear_velocity] * 3
        + [max_base_angular_velocity] * 3
        + [max_finger_joint_velocity] * 12
    )
    src = np.zeros(NUM_DOFS, dtype=np.int64)
    scale = np.zeros(NUM_DOFS)
    for d in range(NUM_BASE_DOFS):
        src[d], scale[d] = d, 1.0
    for control, pairs in FINGER_COUPLING_MAP.items():
        for joint, s in pairs:
            src[DOF_INDEX[joint]] = NUM_BASE_DOFS + control
            scale[DOF_INDEX[joint]] = s
    return ActionPipeline(
        control_mode=control_mode,
        policy_controls_base=policy_controls_base,
        policy_controls_fingers=policy_controls_fingers,
        num_actions=6 * policy_controls_base + 12 * policy_controls_fingers,
        active_lower=np.asarray(model.lower_limit[ACTIVE_IDX], dtype=np.float32),
        active_upper=np.asarray(model.upper_limit[ACTIVE_IDX], dtype=np.float32),
        max_deltas=np.asarray(max_deltas, dtype=np.float32),
        coupling_src=src,
        coupling_scale=np.asarray(scale, dtype=np.float32),
    )


def process_actions(pl: ActionPipeline, actions, active_prev, active_rule):
    """(N, num_actions) actions -> (full_dof_targets (N, 26), active targets
    (N, 18)). `active_rule` is the previous step's pre-action rule output."""
    dev = actions.device
    lo = torch.as_tensor(pl.active_lower, device=dev)
    hi = torch.as_tensor(pl.active_upper, device=dev)
    md = torch.as_tensor(pl.max_deltas, device=dev)
    t = active_rule.clone()
    segs = []
    ofs = 0
    if pl.policy_controls_base:
        segs.append((slice(0, 6), actions[:, 0:6]))
        ofs = 6
    if pl.policy_controls_fingers:
        segs.append((slice(6, 18), actions[:, ofs:ofs + 12]))
    for sl, a in segs:
        if pl.control_mode == "position":
            t[:, sl] = (a + 1.0) * 0.5 * (hi[sl] - lo[sl]) + lo[sl]
        else:
            t[:, sl] = active_prev[:, sl] + a * md[sl]
    if pl.control_mode == "position_delta":
        t = torch.minimum(torch.maximum(t, lo), hi)
    for name in pl.post_action_filters:
        if name == "velocity_clamp":
            t = active_prev + torch.minimum(torch.maximum(t - active_prev, -md), md)
        elif name == "position_clamp":
            t = torch.minimum(torch.maximum(t, lo), hi)
        else:
            raise ValueError(f"unknown post-action filter {name}")
    full = t[:, torch.as_tensor(pl.coupling_src, device=dev)] * torch.as_tensor(
        pl.coupling_scale, device=dev)
    return full, t


def extract_active_targets(full_dof: torch.Tensor) -> torch.Tensor:
    """Inverse of the coupling for reset re-sync: base DOFs + the primary
    joint of each finger control."""
    return full_dof[..., ACTIVE_IDX]
